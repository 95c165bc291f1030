#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxfusion_tpu_torch``) on one NVIDIA GPU.

Drives the port's main path, SVGP regression serving through
``BatchedPredictor``, at production width (M = 512 inducing points,
D = 32, RBF kernel, chunk 8192) on the card, in phases that each print
one line:

1. device: needs CUDA (exits nonzero without it); prints the card's
   name and power limit (nvidia-smi) and the TF32 settings;
2. build: compiles the CUDA RBF gram kernel from
   ``mxfusion_tpu_torch/csrc`` with nvcc for sm_90a;
3. kernel: holds the kernel against its plain PyTorch version on the
   card at the serving shapes (Kzx, Kuu) and one ragged ARD shape,
   max |diff| <= 1e-5 at variance 1, and checks that the HIGHEST-tier
   einsum stays IEEE fp32 with TF32 switched on;
4. serve: loads a seeded state through ``util.carryover``, answers three
   requests (8192, 20000 and 128 rows), checks that the kernel ran
   exactly twice per chunk (Kuu and Kzx), that outputs are finite with
   variances >= -1e-6, that they agree with the plain path (means 1e-4
   relative, variances 1e-4 absolute) and, on 256 rows, with a float64
   numpy evaluation of the predictive formulas (1e-3 relative);
5. timing (information): the kernel's and the plain version's device
   time at the Kzx shape, and serving rows/s with and without the
   kernel.

Any failed check raises and the script exits nonzero. The last three
lines are the card (nvidia-smi), the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py [--seed N]
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
M, D, CHUNK = 512, 32, 8192
REQUESTS = (8192, 20000, 128)
BOX = 4.0              # inputs and inducing points uniform in [0, BOX]^D
KERNEL_ATOL = 1e-5     # tests/ops/test_pallas.py tolerance, variance 1
PLAIN_MEAN_RTOL = 1e-4
PLAIN_VAR_ATOL = 1e-4
F64_RTOL = 1e-3
F64_ROWS = 256
BULK_ROWS = 32 * CHUNK


def check(ok, message):
    if not ok:
        raise RuntimeError("check failed: " + message)


def rel_err(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]


def make_state(rng, softplus_inv):
    """A served SVGP state in the JAX package's unconstrained layout,
    keyed by name path. Kuu is kept well conditioned by spreading Z
    uniformly over the input box with a lengthscale of sqrt(D) (each
    pair of points sits about 1.6 lengthscales apart); q(U) has a
    rank-8 plus 0.01·I covariance."""
    W = np.zeros((M, M))
    W[:, :8] = 0.1 * rng.standard_normal((M, 8))
    return {
        "inducing_inputs": rng.uniform(0.0, BOX, (M, D)),
        "noise_var": softplus_inv(np.full(1, 0.1)),
        "Y.rbf_lengthscale": softplus_inv(np.full(1, math.sqrt(D))),
        "Y.rbf_variance": softplus_inv(np.ones(1)),
        "Y.qU_mean": rng.standard_normal((M, 1)),
        "Y.qU_cov_W": W,
        "Y.qU_cov_diag": softplus_inv(np.full(M, 0.01)),
    }


def rbf_f64(A, B, ls, var):
    d = A[:, None, :] / ls - B[None, :, :] / ls
    return var * np.exp(-0.5 * np.sum(d * d, axis=-1))


def predict_f64(state, softplus, X, jitter):
    """The predictive mean and diagonal variance in float64 numpy
    (svgp_regression.py's _moments, standard parameterization,
    noise-free)."""
    Z = state["inducing_inputs"]
    ls = softplus(state["Y.rbf_lengthscale"])
    var = softplus(state["Y.rbf_variance"])
    W = state["Y.qU_cov_W"]
    S = W @ W.T + np.diag(softplus(state["Y.qU_cov_diag"]))
    Kuu = rbf_f64(Z, Z, ls, var) + jitter * np.eye(M)
    L = np.linalg.cholesky(Kuu)
    Ls = np.linalg.cholesky(S)
    LinvLs = np.linalg.solve(L, Ls)
    Linvmu = np.linalg.solve(L, state["Y.qU_mean"])
    wv = np.linalg.solve(L.T, Linvmu)
    Kxt = rbf_f64(Z, X, ls, var)
    LinvKxt = np.linalg.solve(L, Kxt)
    tmp = (LinvLs @ LinvLs.T) @ LinvKxt
    mu = Kxt.T @ wv
    v = var - np.sum(LinvKxt ** 2, axis=0) + np.sum(tmp * LinvKxt, axis=0)
    return mu, v[:, None], np.linalg.cond(Kuu)


def cuda_ms(fn, reps=50):
    """Device milliseconds per call of ``fn``: the calls are queued behind
    a spin kernel, so they run back to back on the card and the host's
    launch overhead does not enter the time."""
    import torch
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # ~25 ms: the host queues every call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU.", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mxfusion_tpu_torch
    check(Path(mxfusion_tpu_torch.__file__).resolve().parent.parent == ROOT,
          "mxfusion_tpu_torch must come from this checkout, not from {}"
          .format(mxfusion_tpu_torch.__file__))
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.modules import SVGPRegression
    from mxfusion_tpu_torch.inference import BatchedPredictor
    from mxfusion_tpu_torch.ops import cuda_build, cuda_kernels, precision
    from mxfusion_tpu_torch.util.carryover import carryover_params

    dev = torch.device("cuda:0")
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print("phase 1 device: {} | nvidia-smi: {} | torch {} cuda {} | "
          "allow_tf32 matmul={} cudnn={}".format(
              kind, card, torch.__version__, torch.version.cuda,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32), flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    cached = cuda_build.library_path("rbf_gram.cu").exists()
    lib_path = cuda_build.build("rbf_gram.cu")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             lib_path.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln] \
        if lib_path.with_suffix(".log").exists() else []
    print("phase 2 build: {} in {:.3f} s (cached={}) | ptxas: {}".format(
        lib_path.name, build_s, cached, " ; ".join(ptxas)), flush=True)

    # ---- 3. kernel against the plain version, on the card
    softplus_inv = PositiveTransformation().inverse_transform
    rng = np.random.default_rng(args.seed)
    state = make_state(rng, softplus_inv)
    f32 = dict(dtype=torch.float32, device=dev)
    Z = torch.as_tensor(state["inducing_inputs"], **f32)[None]
    Xk = torch.as_tensor(rng.uniform(0.0, BOX, (CHUNK, D)), **f32)[None]
    ls_iso = torch.full((1, 1), math.sqrt(D), **f32)
    var1 = torch.ones((1, 1), **f32)
    Xr = torch.as_tensor(rng.standard_normal((300, 7)), **f32)[None]
    X2r = torch.as_tensor(rng.standard_normal((1000, 7)), **f32)[None]
    ls_ard = torch.as_tensor(rng.uniform(0.5, 2.0, (1, 7)), **f32)
    cases = {"Kzx": (Z, Xk, ls_iso, var1), "Kuu": (Z, None, ls_iso, var1),
             "ragged_ard": (Xr, X2r, ls_ard, var1)}
    max_err = 0.0
    with torch.no_grad():
        for name, (A, B, ls, var) in cases.items():
            K = cuda_kernels.rbf_kernel_matrix(A, B, ls, var)
            P = cuda_kernels._rbf_torch(A, B, ls, var)
            torch.cuda.synchronize()
            err = float((K - P).abs().max())
            shape = tuple(K.shape)
            check(shape == tuple(P.shape) and bool(torch.isfinite(K).all()),
                  "{}: kernel output {} not finite or not {}".format(
                      name, shape, tuple(P.shape)))
            check(err <= KERNEL_ATOL, "{}: max |kernel - plain| = {} > {}"
                  .format(name, err, KERNEL_ATOL))
            max_err = max(max_err, err)
            print("phase 3 kernel: {} {} max_abs_err={:.3e} (tol {:.0e})"
                  .format(name, shape, err, KERNEL_ATOL), flush=True)
        old_tf32 = torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            cross = precision.einsum("...nd,...md->...nm", Z, Xk)
        finally:
            torch.set_float32_matmul_precision(old_tf32)
        ref = torch.einsum("...nd,...md->...nm", Z.double(), Xk.double())
        einsum_err = float(((cross.double() - ref).abs().max()
                            / ref.abs().max()))
        check(einsum_err <= 1e-5, "HIGHEST einsum under allow_tf32=True "
              "has relative error {} (TF32 leaked)".format(einsum_err))
        print("phase 3 kernel: HIGHEST einsum with allow_tf32=True: "
              "relative error vs float64 {:.3e} (IEEE fp32)".format(
                  einsum_err), flush=True)

    # ---- 4. the main path: BatchedPredictor on a carried-over state
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=Variable(shape=(M, D)))
    params = carryover_params(state, [m], dtype="float32", device=dev)
    requests = [rng.uniform(0.0, BOX, (n, D)).astype(np.float32)
                for n in REQUESTS]

    def serve(use_kernel):
        cuda_kernels.set_use_kernel(use_kernel)
        try:
            pred = BatchedPredictor(model=m, infr_params=params,
                                    observed=[m.X],
                                    target_variables=[m.Y.uuid],
                                    chunk_size=CHUNK)
            return [pred.predict(X=x)[0] for x in requests]
        finally:
            cuda_kernels.set_use_kernel(True)

    cuda_kernels.rbf_kernel_matrix.launches = 0
    out_kernel = serve(True)
    launches = cuda_kernels.rbf_kernel_matrix.launches
    chunks = sum(-(-n // CHUNK) for n in REQUESTS)
    check(launches == 2 * chunks, "rbf_gram launched {} times for {} "
          "chunks; expected 2 per chunk (Kuu, Kzx)".format(launches, chunks))
    for n, (mu, var) in zip(REQUESTS, out_kernel):
        check(mu.shape == (1, n, 1) and var.shape == (1, n, 1),
              "output shapes {} {} for {} rows".format(mu.shape, var.shape,
                                                      n))
        check(np.isfinite(mu).all() and np.isfinite(var).all(),
              "non-finite output for {} rows".format(n))
        check(var.min() >= -1e-6, "variance {} < -1e-6".format(var.min()))
    out_plain = serve(False)
    check(cuda_kernels.rbf_kernel_matrix.launches == launches,
          "the plain path launched the kernel")
    mean_err = max(rel_err(a[0], b[0]) for a, b in zip(out_kernel,
                                                      out_plain))
    var_err = max(float(np.max(np.abs(a[1] - b[1])))
                  for a, b in zip(out_kernel, out_plain))
    check(mean_err <= PLAIN_MEAN_RTOL, "kernel vs plain path: mean rel err "
          "{} > {}".format(mean_err, PLAIN_MEAN_RTOL))
    check(var_err <= PLAIN_VAR_ATOL, "kernel vs plain path: variance abs "
          "err {} > {}".format(var_err, PLAIN_VAR_ATOL))
    softplus = PositiveTransformation().transform
    mu64, var64, cond = predict_f64(
        state, lambda x: softplus(torch.as_tensor(x)).numpy(),
        requests[1][:F64_ROWS].astype(np.float64),
        m.Y.factor.jitter)
    f64_mean = rel_err(out_kernel[1][0][0, :F64_ROWS], mu64)
    f64_var = rel_err(out_kernel[1][1][0, :F64_ROWS], var64)
    check(f64_mean <= F64_RTOL and f64_var <= F64_RTOL,
          "vs float64: mean rel err {}, variance rel err {} (tol {})"
          .format(f64_mean, f64_var, F64_RTOL))
    print("phase 4 serve: requests {} -> {} chunks, rbf_gram launches {} "
          "(2 per chunk) | vs plain: mean rel {:.3e}, var abs {:.3e} | vs "
          "float64 ({} rows, cond(Kuu)={:.3e}): mean rel {:.3e}, var rel "
          "{:.3e}".format(list(REQUESTS), chunks, launches, mean_err,
                          var_err, F64_ROWS, cond, f64_mean, f64_var),
          flush=True)

    # ---- 5. timing, for information
    with torch.no_grad():
        ms = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = cuda_kernels._rbf_torch if which == "plain" \
                else cuda_kernels.rbf_kernel_matrix
            ms[which].append(cuda_ms(lambda: fn(Z, Xk, ls_iso, var1)))
    bulk = rng.uniform(0.0, BOX, (BULK_ROWS, D)).astype(np.float32)
    rows_s = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        cuda_kernels.set_use_kernel(which == "kernel")
        try:
            pred = BatchedPredictor(model=m, infr_params=params,
                                    observed=[m.X],
                                    target_variables=[m.Y.uuid],
                                    chunk_size=CHUNK)
            pred.predict(X=bulk[:CHUNK])
            t0 = time.perf_counter()
            pred.predict(X=bulk)
            rows_s[which].append(BULK_ROWS / (time.perf_counter() - t0))
        finally:
            cuda_kernels.set_use_kernel(True)
    print("phase 5 timing ({}): rbf gram at Kzx ({} x {}, D={}): kernel {} "
          "ms, plain {} ms | serving {} rows at chunk {}: kernel {} rows/s, "
          "plain {} rows/s".format(
              card, M, CHUNK, D, ms["kernel"], ms["plain"], BULK_ROWS, CHUNK,
              rows_s["kernel"], rows_s["plain"]), flush=True)

    check(not any(k == "jax" or k.startswith(("jax.", "mxfusion_tpu."))
                  or k == "mxfusion_tpu" for k in sys.modules),
          "JAX or the JAX package was imported")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "rbf_gram", "route": "cuda",
        "source": "mxfusion_tpu_torch/csrc/rbf_gram.cu",
        "replaces": "mxfusion_tpu/ops/pallas_kernels.py:89",
        "launches": launches, "max_abs_err": max_err,
        "ms": min(ms["kernel"]), "plain_ms": min(ms["plain"])}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
