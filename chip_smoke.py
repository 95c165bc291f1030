#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mxfusion_tpu_torch``) on one NVIDIA GPU.

Drives the port's main paths on the card: SVGP regression serving
through ``BatchedPredictor`` (M = 512 inducing points, D = 32, RBF
kernel, chunk 8192), SVGP training through ``GradBasedInference(MAP,
DeviceMinibatchLoop)`` at the bench.py headline step shape (B = 65536),
the multivariate-normal slice (structured-PPCA SVI with a
full-covariance posterior, then forward sampling), and the exact and
collapsed GP modules (``GPRegression`` at the exact-GP bench's N = 1024,
``SparseGPRegression`` at N = 65536, M = 512) with the GP kernel family,
the mean-field slice (SVI, IWAE, BBVI and ADVI over constrained
latents), which launches none of the kernels, the non-Gaussian
SVGPs (binary and multi-class classification, Poisson and negative
binomial counts) at B = 65536, M = 512, D = 32, whose grams are K1's,
and the rest of the GP module family: the LMC multi-output SVGP, 2-layer
deep GPs (regression and classification) and natural-gradient SVGP
training, minibatch and full batch, and persistence at the training
slice's configuration (a checkpointed run resumed, a saved inference
loaded onto a rebuilt model, an exported predictor served by a process
that builds no model), and networks in the graph (``NNFunction``): a
deep-kernel SVGP trained and served at the training slice's
configuration, and BASELINE config 5's Bayesian NN and VAE, and the
MCMC samplers (SGLD, HMC, parallel tempering, ChEES-HMC and SVGD) on
benchmarks/mcmc_throughput.py's Bayesian linear regression and over a
GP module, whose potential K1 builds, and the evidence and
model-criticism layer (Laplace through K1, thermodynamic integration
with K1 in every rung's potential, WAIC, PSIS-LOO, predictive checks)
and observation masks, and the state-space slice (the Kalman filter and
RTS smoother, sequential and parallel in time, ``LinearGaussianSSM`` by
MAP, ``GaussianAR1`` under HMC for stochastic volatility, and PILCO,
whose GP dynamics K1 builds in every fit step and rollout step), the
loops' options and data parallelism, the exported artifacts of a
network graph and of a prediction that draws, the 27 example
scripts and the 9 tutorial notebooks, and the keyed gamma and Poisson
draws (R1, R2) with the drawing artifacts they let export. In phases
that each print one line:

1. device: needs CUDA (exits nonzero without it); prints the card's
   name and power limit (nvidia-smi) and the TF32 settings;
2. build: compiles the CUDA kernels from ``mxfusion_tpu_torch/csrc``
   with nvcc for sm_90a, one nvcc per source, all started together:
   ``rbf_gram.cu`` (K1), ``fused_gram.cu`` (K2, K3),
   ``batched_cholesky.cu`` (K4, K5) and ``keyed_draws.cu`` (R1, R2);
3. kernel: holds each kernel against its plain PyTorch version on the
   card: K1 at the serving shapes (Kzx, Kuu), the materialized training
   arm's Kuf (512 x 65536), the exact GP's (phases 14 and 16) Kxx
   (1024², D = 4, X2 None), Kxt (1024 x 8192, D = 4) and Kxx on the
   ``active_dims`` copy (D = 2), one ragged ARD shape and
   three whose M % 4 != 0 takes its 4-byte stores (M = 8191; two samples
   at M = 130 and at M = 1), and, through ``RBF.K``'s route, the deep
   GP's inner-layer Kuf (Z at s = 1 against 5 samples of 65536 inputs,
   D = 30, expanded to one launch), max |diff| <= 1e-5 at variance 1;
   K2 (rtol 2e-4, atol 2e-5) and K3
   (2e-3 of each output's largest entry, and the same bits on a second
   call) at the training shape (M = 512, N = 65536, D = 32), a ragged
   shape the gate admits and two shapes (N = 4104 and 100000, N % 4 = 0)
   whose dU slices start inside a 16-byte group unless they are aligned,
   each with ``lower`` True and False on an L⁻¹ stand-in whose upper
   triangle is not 0; checks that the
   HIGHEST-tier einsum stays IEEE fp32, forward and gradient, with TF32
   switched on; and K1's route on inputs broadcast over s = 3 samples (a
   GP log-pdf of three samples of f, an SVGP bound with three sampled
   noise variances): K1 launches once and twice, and float32 agrees
   with float64 (the plain branch) within 1e-4 relative;
4. serve: loads a seeded state through ``util.carryover``, answers three
   requests (8192, 20000 and 128 rows), checks that the kernel ran
   once per chunk (Kzx) and once more (Kuu, which the predictor builds
   once for its parameters and keeps), that outputs are finite with
   variances >= -1e-6, that they agree with the plain path (means 1e-4
   relative, variances 1e-4 absolute) and, on 256 rows, with a float64
   numpy evaluation of the predictive formulas (1e-3 relative);
5. timing (information): K1's and its plain version's device time at
   serving's Kzx (512 x 8192) and Kuu and the materialized arm's Kuf
   (512 x 65536), D = 32, at the exact GP's Kxx (1024²) and Kxt
   (1024 x 8192), D = 4, and at the deep GP's Kuf (5 x 512 x 65536,
   D = 30), each beside its bound, and serving rows/s with and without
   the kernel;
6. train: MAP with Adam (lr 3e-3) for one epoch of 4 steps on 262144
   seeded rows, once through the fused arm and once with
   ``fused_gram.disabled()`` (materialized Kuf) from the same start and
   the same permutation; checks the launches of every step (K2 once,
   K3 three times, K1 once for Kuu on the fused run), finite losses,
   fused vs materialized losses within 1e-3 relative, the first loss
   against a float64 evaluation of the bound within 1e-3 relative, and
   serves 8192 rows from the trained store; prints the median and
   quartiles of the step wall time of both arms over STEP_WALL_ROUNDS
   rounds of (materialized, fused, fused, materialized) epochs; then
   evaluates the bound and its gradient at a Kuu that
   is not positive definite (jitter 0, a lengthscale far beyond the
   box): the loss is NaN, as in JAX, and nothing raises;
7. timing (information): K2 and K3 against their plain versions at the
   training shape, ``lower`` True (the bound's) and False, and the
   plain backward with its two M²N products in TF32 (cuBLAS at the
   kernel's precision);
8. cholesky: K4 and K5 (``batched_cholesky.cu``) against the plain
   version at 512×32², 512×64², 2048×64², 512×128², 8192×64², a ragged
   B (777×60²), n = 20, the tier edges (n = 32, 33, 64, 65, 128 at
   B = 1 and 3) and the block tier at 2048×128², 512×96² and 33×100²
   (n % 4 != 0): error within 5e-6 of max |L| of the float64 factor,
   upper triangle exactly 0, the same bits over two calls, K4's custom
   gradient within 1e-4 of ``torch.linalg.cholesky``'s; and the plain
   version's NaN pattern on matrices that are not positive definite, at
   n = 20, 40 and 70;
9. ppca: the MVN slice's main path at full width, structured PPCA
   (N = 2048, Q = 64, D = 128, a full-covariance posterior per point)
   by ``GradBasedInference(StochasticVariationalInference)`` with S = 4
   and 20 Adam steps: K4 three times per step, the loss falls, the
   first loss on fixed draws float32 vs float64 within 1e-4; prints the
   step wall time; 9b. the same at Q = 128, N = 512 (log-pdf stacks
   2048×128², K4's block tier), 5 Adam steps;
10. sampling: ``VariationalPosteriorForwardSampling`` and
   ``ForwardSampling`` (16 draws each; K4 once each); the draws of z,
   whitened by the float64 factor of q's (or the prior's) covariance,
   have mean 0 and covariance I within 8/sqrt(16·N);
11. r3 entry: ``batched_cholesky_r3`` (K5, which no library path calls,
   as in JAX) on the trained posterior's covariance stack, against K4;
12. timing (information): K4, K5, the plain version and
   ``torch.linalg.cholesky_ex`` alone (the library call) at six stacks,
   beside the bound, with each kernel's share of it;
13. profile (information): ten structured-PPCA SVI steps under
   ``torch.profiler``: wall, device busy time and idle share, and the
   device time by kernel (the Chrome trace goes to ``build/``);
14. exact GP: ``GPRegression`` (RBF) at benchmarks/gp_exact_1k.py's
   configuration (N = 1024, D = 4, noise 0.1), MAP with Adam (lr 3e-2)
   for 25 steps: K1 once per step (Kxx), the losses fall, the first loss
   float32 vs float64 within 1e-4; then an 8192-row request through
   ``BatchedPredictor`` (K1 once, Kxt) against a float64 numpy closed
   form on 256 rows (1e-3 relative) and four prior draws
   (``ForwardSampling``); prints the median step wall over steps 2-25;
15. collapsed GP: ``SparseGPRegression`` (RBF) on the first 65536 rows
   of phase 6's data, M = 512, D = 32, full batch, MAP with Adam (lr
   3e-3) for 4 steps: K1 twice per step (Kuu, Kuf), the first loss
   float32 vs float64 within 1e-3, the loss and gradient with the data
   tier at TF32 equal to those at HIGHEST within 1e-6 (the bound pins
   HIGHEST in both directions); an 8192-row request (K1 once) against
   float64 numpy on 256 rows (1e-3); prints the median step wall;
16. kernel family: the exact GP's log-pdf and gradient at N = 1024,
   D = 4 with ``RBF(active_dims=[0, 1]) + Matern52 + White`` and with
   ``RBF * Linear``: K1 once (one RBF gram each), float32 vs float64
   within 1e-4 (loss) and 1e-3 (gradients);
17. profile (information): ten exact-GP and four collapsed-GP MAP steps
   under ``torch.profiler``, as phase 13 (traces in ``build/``);
18. mean-field PPCA: BASELINE config 1 at phase 9's widths and data
   (N = 2048, Q = 64, D = 128) under ``create_Gaussian_meanfield``,
   ``StochasticVariationalInference`` with S = 10 and 20 Adam steps: no
   launch of K1-K5, the loss falls, the first loss on fixed draws
   float32 vs float64 within 1e-4; prints the step wall's median and
   quartiles over steps 2-20;
19. mean-field linear regression: config 2 on the first 65536 rows of
   phase 6's data (D = 32, a learned noise variance), the same checks;
   and ``ImportanceWeightedVariationalInference`` at S = 64: its bound
   is at least the ELBO on the same draws; then ten SVI steps of each
   of phases 18 and 19 under ``torch.profiler`` (the idle share);
20. BBVI: ``ScoreFunctionInference`` and ``ScoreFunctionRBInference`` on
   phase 19's model and state at S = 4096 fixed draws: the gradient in
   q's mean within five standard errors (of the per-sample differences)
   of the pathwise SVI gradient on the same draws; then 20 steps of each
   with finite losses;
21. ADVI: Gamma-Exponential, Beta-Bernoulli and Dirichlet-Categorical
   (K = 16) on N = 65536 observations drawn on the card: the mean-field
   factor is LogNormal, LogitNormal and StickBreakingNormal, and q's
   mean, from draws of the fitted factor, lies within 3% of the
   conjugate posterior's; then 2^20 draws of each distribution of the
   slice on the card's generator: means and variances within six
   standard errors of the closed forms (LogitNormal and
   StickBreakingNormal against float64 numpy pushforwards of normal
   draws; InverseGamma at alpha = 6);
22. classification: ``SVGPClassification`` on phase 6's 262144 rows
   with labels y ~ Bernoulli(sigmoid(3 f)), M = 512, D = 32, 20
   Gauss-Hermite points, MAP + ``DeviceMinibatchLoop`` at B = 65536 and
   Adam (lr 3e-3): the logit link unwhitened (the wide arm) for 8 steps,
   then the probit link whitened for 4; K1 exactly twice per step (Kuu,
   Kuf), finite losses, the first loss float32 vs float64 at the same
   state and batch within 1e-3; the step walls' median and quartiles,
   and ten logit steps under ``torch.profiler`` (the idle share);
23. classification serving: each trained store answers a 262144-row
   request in chunks of 8192 and a 128-row one through
   ``BatchedPredictor``: K1 twice per chunk, probabilities in (0, 1),
   the logit quadrature and the probit closed form against float64
   numpy on 256 rows within 1e-3; rows/s and the small request's
   latency;
24. counts: ``SVGPPoissonRegression`` (y ~ Poisson(exp f); log and
   softplus links) and ``SVGPNegBinomialRegression`` (a Gamma-Poisson
   draw at dispersion 0.5, the dispersion learned), 4 steps each at
   B = 65536: K1 twice a step, the first loss vs float64, the step wall;
25. multi-class: ``SVGPMultiClassification`` with C = 10 classes by the
   equal-count bins of f and K = 8 draws a point (a (1, 65536, 10, 8)
   tensor), 4 steps: K1 twice a step, the first loss on fixed draws
   float32 vs float64 within 1e-3; 8192 served rows whose probabilities
   sum to 1 within 1e-5;
26. draws: 2^20 draws each of Laplace, Student-t (nu = 5), Uniform,
   Poisson, NegativeBinomial, Concrete (the argmax's frequencies),
   NormalMixture and Wishart (D = 8, mean n·S): means and variances
   within six standard errors of the closed forms; and the gamma draw's
   gradient in alpha on the card (float32) within 1e-5 of the ported
   ``random_gamma_grad`` in float64 at alpha = 0.1, 0.7, 2, 6 and 50,
   with the iterations each backward ran;
27. LMC: ``LMCSVGPRegression`` at benchmarks/lmc_scale.py:22's shape
   (B = 65536, M = 512, D = 32, Q = 8 latents, C = 16 outputs mixed from
   8 latent functions of phase 6's inputs plus noise), MAP +
   ``DeviceMinibatchLoop``, Adam at lr 3e-3, 4 steps: K1 twice a step,
   finite losses, the first loss float32 vs float64 within 1e-3; then a
   65536-row request with the full 16 x 16 output covariance and a
   128-row one (K1 twice a chunk), against float64 numpy on 256 rows
   within 1e-3; rows/s and the latency;
28. deep GP regression: ``DeepGPRegression``, RBF(32) -> 30 hidden ->
   RBF(30) -> 1, M = 512 a layer, S = 5 draws, whitened, the linear
   inner mean, on phase 6's rows at B = 65536, 4 Adam steps: K1 four
   times a step (layer 1's Kuf at s = 5 among them), finite losses, the
   first loss on fixed draws float32 vs float64 within 1e-3; ten steps
   under ``torch.profiler``; a 65536-row request (20 draws, K1 four
   times a chunk) with finite moments, and the moments on fixed draws
   float32 vs float64 on 256 rows within 1e-3;
29. deep GP classification: phase 28's stack with phase 22's labels and
   the logit link, 4 steps, the same checks; served probabilities in
   (0, 1);
30. natural gradients, minibatch: benchmarks/svgp_1m.py's ngd mode (10^6
   rows of its data, d = 8, B = 4096, M = 256, gamma 0.1, N/B scaling):
   one epoch (245 steps) of ``NaturalGradientMinibatchLoop`` and one of
   ``DeviceMinibatchLoop`` from one start and one permutation: K2 once,
   K3 three times and K1 once a step, NGD's epoch loss below Adam's, the
   NaN guard's trips printed, both step walls;
31. natural gradients, full batch: phase 15's configuration (N = 65536,
   M = 512, D = 32) with the hyperparameters fixed, three
   ``NaturalGradientLoop`` steps at gamma 1 in float64: step 2's loss is
   the collapsed bound (``SparseGPRegression``, float64) within 1e-6;
   then the same in float32 with K1, K2 and K3 on, its gap to the bound
   and the guard's trips printed (information).
32. checkpoint/resume: phase 6's model, start and loop (B = 65536, Adam
   at lr 3e-3) on the first 131072 rows, two epochs of two fused steps;
   a run under ``CheckpointCallback`` snapshots every epoch (every 2
   steps) and stops after epoch 1; a third run resumes from the step-2
   snapshot through ``load_params`` and ``resume_state=``. K1/K2/K3
   1/1/3 in every step of the three runs, and the resumed losses at
   steps 3-4 equal the uninterrupted run's within 1e-6 relative;
33. save/load: ``Inference.save`` of phase 6's trained inference, the
   model rebuilt in code (fresh UUIDs), ``Inference.load`` onto it, and a
   ``BatchedPredictor`` on the loaded store answering phase 5's
   262144-row request (32 chunks, K1 once a chunk and once for Kuu,
   which a new predictor builds once) against phase 6's
   live predictor at phase 4's serving tolerances (means 1e-4 relative,
   variances 1e-4 absolute); the walls of save and load;
34. export: ``BatchedPredictor.export`` of the live predictor, served by
   ``load_exported_predictor`` in a subprocess that builds no model,
   imports no JAX and sets ``torch.set_float32_matmul_precision
   ("medium")``: the same request at the same tolerances, K1 twice a
   chunk by the artifact's own count and, in a ``torch.profiler`` window
   of one chunk, ``rbf_gram_kernel`` twice; the program holds K1 as two
   operator nodes and every product as a tiered operator, no plain
   matmul; the artifact and the live predictor timed alternately in this
   process too; the walls of export and
   load, the artifact's size, and rows/s and 128-row latency of the
   artifact beside the live predictor (information);
35. deep-kernel training: a network Linear(32, 64) -> tanh ->
   Linear(64, 32) (``NNFunction``) in front of phase 6's SVGP (RBF over
   the features, M = 512, Z at the features of 512 rows), MAP +
   ``DeviceMinibatchLoop`` at B = 65536 on phase 6's 262144 rows, one
   epoch of 4 Adam steps, fused and materialized from one start: K1/K2/K3
   1/1/3 in each fused step (K3's dXs is the network's gradient), the
   two arms' losses within 1e-3, the first loss against float64 within
   1e-3, every network weight's gradient at the start state, fused vs
   materialized, within 5e-3 of its largest entry; the step wall's median
   and quartiles beside phase 6's;
36. deep-kernel serving: ``BatchedPredictor`` with ``X_raw`` observed on
   262144 rows (the network runs on each chunk): K1 once a chunk (Kzx;
   the warm predictor keeps Kuu's factors), kernel
   vs plain path (means 1e-4 relative, variances 1e-4 absolute), 256 rows
   vs a float64 store (1e-3); rows/s and the 128-row latency;
37. BNN (BASELINE config 5a, benchmarks/bnn_vae_dp.py's widths): N =
   8192, 8 -> 64 -> 64 -> 1 tanh with Normal(0, 1) priors over its 4801
   weights, mean-field SVI at S = 4, 20 Adam steps: no launch of K1-K5,
   the loss falls, the first loss on fixed draws float32 vs float64
   within 1e-4, the step wall and the idle share of a 10-step profile;
   then 4000 more steps (eight runs of 500) and 100 forward draws
   (``VariationalPosteriorForwardSampling``) whose mean lies within 0.1
   of sin(3 x0) on average;
38. VAE (config 5b): N = 8192, D = 16, K = 4, decoder 4 -> 64 -> 16,
   encoder 16 -> 64 -> (4, 4) in the posterior, SVI at S = 3: the checks
   of phase 37 but the forward draws;
39. MCMC throughput: benchmarks/mcmc_throughput.py's Bayesian linear
   regression (N = 100 000, D = 32, float32, 8 chains, data from
   ``--seed``): SGLD (B = 1024, constant step), HMC (L = 8, eps0 =
   0.01), parallel tempering (6 temperatures, L = 8) and ChEES-HMC, 200
   warmup each, kept draws cut to fit (ChEES, whose proposals take
   about 38 leapfrog steps here, to 100); each run twice, the second
   timed: kept draws/s and potential-and-gradient evaluations/s, accept rate,
   adapted step, ChEES's mean leapfrog steps, PT's swap acceptance,
   max R-hat, and the idle share of a profiled window of 20 transitions;
   the mean of w within 6 Monte-Carlo standard errors (by ESS) of the
   float64 closed form (SGLD: 10, of its chains' average); the potential
   evaluations each run counts as stated (1 + L a transition for HMC and
   PT, one a step for SGLD); no launch of K1-K5; and the benchmark's own
   SGLD step (1e-5) run for 300 steps beside this posterior's stability
   limit;
40. samplers over a GP module: tests/inference/test_mcmc_over_modules.py's
   noise variance under Gamma(2, 20) in ``GPRegression`` on phase 14's
   data (N = 1024, D = 4, noise 0.1): K1 against its plain version at one
   potential and gradient of 4 chains (the exact GP's tolerances); HMC
   (4 chains, L = 8, 150 + 150) and SVGD (16 particles, 150 iterations):
   K1 once per potential evaluation (1 + 8 a transition, 1 an
   iteration), the posterior means inside the JAX test's bands;
41. a correlated posterior: ChEES-HMC on tests/inference/test_chees.py's
   design scaled to N = 65536, D = 32 (mean leapfrog steps above 1.5,
   beside phase 39's), and SVGD (16 particles, 50 iterations, float32)
   on the card against the port on the CPU from the same particles,
   within 1e-4 of the particles' largest entry;
42. Laplace: (a) phase 39's BLR (N = 100 000, D = 32, float32) at the
   float64 mode, Σ within 1e-4 of its largest entry and the log evidence
   within 1e-5 of the float64 closed form, no launch; (b) phase 40's GP
   after 500 MAP steps (K1 once a step), Laplace launching K1, its log
   evidence and marginal variance within 1e-4 and 1e-3 of float64 on the
   CPU at the same point; (c) phase 6's SVGP on 65536 rows with a Gamma
   noise latent: 4 fused MAP steps (K1/K2/K3 1/1/3 a step), then Laplace
   with the gate open launching K1 and neither K2 nor K3, its log
   evidence within 1e-3 of float64 on the CPU;
43. thermodynamic integration: (a) a power posterior over 42b's GP at its
   MAP hyperparameters (2 chains x 16 rungs, L = 8, 100 + 200 sweeps):
   at one potential over the 32 replicas K1 launches once at (32, 1024,
   1024) and the potential, log likelihood and gradient agree with its
   plain version (1e-4, 1e-4, 1e-3); on the run K1 launches once per
   potential evaluation, every gram at (32, 1024, 1024) as the launches
   record it, the evidence within 1 nat of 42b's Laplace, a profile of 5
   sweeps; (b)
   tests/inference/test_evidence.py's Gamma-Exponential oracle (150 +
   200 sweeps): the closed form within 0.15, tau's mean within 5%, every
   swap acceptance above 0.3;
44. model comparison: SGLD on phase 39's BLR and on a misspecified model
   that sees 16 of its 32 features (8 chains, 200 draws a chain, thin
   10): the (1600, 100 000) pointwise log-likelihood in one evaluation,
   WAIC and PSIS-LOO on the card, equal to the port's CPU evaluation on
   4096 columns within 1e-9 (pointwise), the true model ahead on both,
   Pareto k < 0.7 for more than 90% of the points, and a predictive
   check of var(y) with p in (0.05, 0.95);
45. observation masks: 20% of phase 39's y masked by an (N, 1) mask (and
   set to 1e6): the masked objective at one state within 1e-6 of the
   observed subset's, and 20 MAP steps on each from one start within
   1e-5, step for step;
46. kalman: a D = 4, E = 2 system (benchmarks/NOTES.md:356-375's shape):
   the log-likelihood of the parallel filter at T = 1024, 8192 and 65536
   and of the sequential one at T = 1024 and 8192, float32 on the card
   against float64 on the CPU within 1e-5 relative; the walls forward
   and forward+backward (into A, Q and R), the sequential one's at
   T = 1024 with its host cost a step; at T = 8192 one batched
   sequential run filters the series and a 30%-masked copy of it
   (placeholders 1e6), each against float64; the RTS smoothers,
   sequential against parallel, at T = 8192 (1e-5 of the largest entry);
   no host sync in the sequential filter, its backward and the smoother
   (``torch.cuda.set_sync_debug_mode("error")``); a profile of each
   filter's forward (idle share); no launch of K1-K5;
47. SSM MAP: the golden_ssm_map model at D = 4, E = 2 on phase 46's
   data, 20 Adam steps with the parallel filter at T = 65536 and 2 with
   the sequential one at T = 1024 (cut from 10 for time): the losses
   fall, the first loss against float64 within 1e-5, the step walls;
48. stochastic volatility: examples/stochastic_volatility.py's model at
   T = 2520, HMC with 2 chains and L = 16, 100 + 100 transitions: the
   posterior mean's correlation with the true path above 0.5 and the 90%
   band's coverage above 0.75 (the example's asserts); evaluations/s;
49. PILCO: examples/pilco/pilco_example.py's configuration (dynamics and
   policy fits cut to 100 and 40 steps): the cost falls and the gain is
   negative; then a 4-state, 1-action linear system at the cart-pole
   widths (N = 1024, an RBF over 5 inputs, Y (1024, 4), horizon 25, 64
   samples, 20 dynamics and 5 policy steps): K1 once a dynamics step and
   once a rollout step, one rollout's cost and policy gradient with K1
   against its plain version (1e-4, 1e-3), the step walls and the idle
   share of two profiled policy steps;
50. native batcher: the library builds on this host
   (``native_available()``), ``shuffled_indices(10^6, e)`` is a
   permutation and, at N = 4097, equals a pure-Python splitmix64
   Fisher-Yates (the plain version), and ``gather_rows`` equals numpy
   indexing on the 10^6 x 9 table of phase 51;
51. the north star's host path: benchmarks/svgp_1m.py's data and model
   (N = 10^6, d = 8, M = 256, B = 4096, N/B scaling, MAP, Adam) through
   ``MinibatchInferenceLoop``, one epoch each at ``batches_per_call`` 1,
   5 (the same 245 batches: epoch losses within 1e-5) and 20 (260 steps,
   15 wrapped; JAX's setting): the epoch walls, one host-to-device copy
   a call, K1/K2/K3 once/once/three times a step, and the idle share of
   a k = 20 epoch traced through ``util.profiling.trace``;
52. remat: one step with and without ``create_executor(remat=True)`` at
   one state, batch and generator seed, at the headline SVGP step
   (B = 65536, M = 512, D = 32) and at phase 18's mean-field SVI: equal
   losses, the generator where the plain step leaves it, gradients within
   1e-6 of each largest entry (bit-equality reported), the peak memory
   both ways, K2 twice under remat;
53. data parallel over a world of one: ``initialize_distributed`` (one
   process: a no-op) and ``make_mesh()`` (NCCL), then
   ``DataParallelMinibatchLoop(batches_per_call=5)`` at phase 51's
   configuration (the epoch loss within 1e-6 of phase 51's k = 5),
   ``DataParallelBatchLoop`` on BASELINE config 5 (the BNN and the VAE
   at phases 37-38's widths, 20 steps, within 1e-5 of
   ``BatchInferenceLoop``'s), ``BatchedPredictor(mesh=)`` on 262144 rows
   against the plain predictor, and HMC on phase 39's BLR over
   ``shard_data`` against the unsharded chain; the step walls; the model
   axis: ``make_mesh_2d(1, 1)`` with q(U) and Z placed over ``model`` by
   ``device_put``, 4 ``make_shard_map_step`` Adam steps at the headline
   shape (B = 65536, M = 512, D = 32, the fused arm, phase 6's data and
   start) against the replicated step (losses within 1e-6, bit-equality
   reported, K1/K2/K3 once/once/three times a step, both step walls),
   then one step each way at benchmarks/model_axis_2d.py's M = 2048,
   D = 16, B = 4096 and the bytes this rank holds of q(U), Z and their
   Adam moments; and the process group torn down;
54. the network artifact: phase 36's deep-kernel predictor exported at
   chunk 8192 (the network's products recorded at IEEE fp32) and served
   by ``load_exported_predictor`` in a subprocess that builds no model,
   imports no network class and sets the float32 matmul precision
   "medium": a 262144-row request at phase 4's serving tolerances
   against the live predictor, K1 twice a chunk by the artifact's count
   and in a profiled chunk, rows/s and the 128-row latency beside the
   live predictor's;
55. the drawing artifact: phase 28's deep GP predictor exported with its
   propagation draws as program inputs, served on 262144 rows from
   ``torch.Generator("cuda").manual_seed(s)`` for s = 1, 2 against the
   live predictor on the same seed (the difference stated; bit-equal
   expected), the two seeds' means apart, K1 four times a chunk, rows/s
   beside the live predictor's;
56. the examples: every ``examples/torch/`` script's ``main()`` in this
   process at ``MXF_SMOKE`` size, held to the band of its CPU test
   against the JAX example's value, with its wall and its K1-K4
   launches; then at full size, cheapest first, while the phase has run
   under 110 s (each script's own full-size assertions apply), the
   scripts left at smoke size listed;
57. the notebooks: the code cells of every ``examples/torch/notebooks/``
   notebook, each in one namespace in this process, on the card at the
   notebook's own counts; every printed number finite and in the band
   of its CPU test (``tests/test_torch_notebooks_a.py``) around the JAX
   notebook's, with the notebook's wall and its K1-K5 launches (K1 at
   least once in ``gp_regression``, ``svgp_regression`` and ``deep_gp``,
   K2 and K3 in ``svgp_regression``), and the phase's total time;
58. keyed draws: (a) the raw Threefry-2x32 words of 2^20 counters, R1
   (``keyed_standard_gamma``) at 2^20 elements of each of GAMMA_ALPHAS
   and R2 (``keyed_poisson``) at each of POISSON_RATES, float32 and
   float64, against their plain versions on the card (every float32
   draw and every count equal to the bit, float64 gamma within
   GAMMA_F64_ULPS in no more draws than GAMMA_F64_ULP_DRAWS at seed 0; a
   parameter broadcast from one value, read at stride 0, equal to the
   dense one), their means and variances within six standard errors of
   the closed forms, with their times beside ``torch._standard_gamma``'s and
   ``torch.poisson``'s (information), the launch's tile and warps an SM
   and the lane efficiency of its schedule beside one thread an
   element's, both emulated from the plain versions' hashes
   (``keyed_random.emulate_schedule``); (c) phase 28's trained deep GP
   with tests/test_torch_export.py's Student-t propagation, exported
   (the program holds one keyed_gamma node) and served on 262144 rows
   from ``torch.Generator("cuda")`` seeds 1 and 2: bit-equal to the live
   predictor, the generators' states equal, R1 once a chunk in both;
   and a count predictor (a network, softplus, a ``NegativeBinomial``)
   MAP-fitted on phase 24's counts, exported and served in a process
   that builds no model, bit-equal to the live predictor on both seeds
   with R1 and R2 once a chunk each, its counts' mean within six
   standard errors of the predicted means and their variance within 5%
   of the law's; rows/s beside phase 55's normal-only artifact; (b) R1
   and R2 timed at those paths' shapes against their plain versions and
   the library calls, beside their bounds, both schedules' lane
   efficiency and the one-thread-an-element kernels' times
   (ONE_THREAD_AN_ELEMENT_MS) (information; 58a and 58b run alone,
   on a stand-in for the count predictor's means, through
   ``keyed_phases_alone``); (d) phases 20, 21 and 26's
   checks (BBVI, ADVI, the library's draws, the gamma draw's gradient)
   ran on the keyed draws with their bounds as they were; R1's and R2's
   launches on the main paths by path (phases 21 and 26's draws, the
   examples, the notebooks, 58c's live and served runs), each run's
   counted from zero just before it and read just after it.

Any failed check raises and the script exits nonzero. The last three
lines are the card (nvidia-smi), the kernels' JSON record (each with
its time, its plain version's, its bound from this run's shapes and
the card's published peaks, and the library call's where one PyTorch
call computes the same function) and ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py [--seed N]
"""
import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
M, D, CHUNK = 512, 32, 8192
REQUESTS = (8192, 20000, 128)
BOX = 4.0              # inputs and inducing points uniform in [0, BOX]^D
KERNEL_ATOL = 1e-5     # tests/ops/test_pallas.py tolerance, variance 1
# the training slice: bench.py's headline step shape
TRAIN_N, TRAIN_B, TRAIN_STEPS = 262144, 65536, 4
# the step wall is a host-clock reading of a step that idles the card
# half the time: 24 steps per arm, the arms alternated, so that the
# quartiles show the spread
STEP_WALL_ROUNDS = 3
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5   # tests/ops/test_pallas_fused_gram.py
BWD_RTOL = 2e-3                   # of each cotangent's largest entry
# fused vs materialized Kuf: the two arms round the 512 x 65536 gram and
# its products differently in fp32; Kuu's conditioning (about 2e3)
# amplifies that, and Adam's first steps move every parameter by about
# lr whatever the gradient's size, so the losses part at ~1e-4
TRAIN_LOSS_RTOL = 1e-3
# float32 vs float64 at the same start: the data tier runs the bound's
# L⁻¹Kuf·L⁻¹Ls product in TF32 (a 10-bit mantissa) on the card
F64_LOSS_RTOL = 1e-3
# float32 through K1 vs float64 (plain) on 40 points: the gram's fp32
# rounding amplified by its Cholesky at jitter 1e-2
BROADCAST_RTOL = 1e-4
PLAIN_MEAN_RTOL = 1e-4
PLAIN_VAR_ATOL = 1e-4
F64_RTOL = 1e-3
F64_ROWS = 256
BULK_ROWS = 32 * CHUNK
# the MVN slice: the batched Cholesky at the shapes the JAX package
# measured K4 at (benchmarks/NOTES.md), the structured-PPCA SVI step's
# log-pdf stack (S·N = 8192), a ragged B and an n that is not a
# multiple of 8
CHOL_SHAPES = ((512, 32), (512, 64), (2048, 64), (512, 128), (8192, 64),
               (777, 60), (512, 20),
               # the tier edges (a warp per matrix up to n = 32 and 64, a
               # block above) at B that are not multiples of the matrices
               # per block
               (1, 33), (3, 65), (1, 128), (3, 64), (3, 32),
               # the block tier: the Q = 128 PPCA step's stack, n = 96, and
               # n % 4 != 0 (4-byte copies) at a ragged B
               (2048, 128), (512, 96), (33, 100))
CHOL_TIMED = ((512, 32), (512, 64), (2048, 64), (512, 128), (8192, 64),
              (2048, 128))
CHOL_MAIN = (8192, 64)  # the PPCA step's log-pdf stacks: the JSON's times
CHOL_RTOL = 5e-6       # of max |L|: tests/ops/test_cholesky_variants.py
CHOL_GRAD_RTOL = 1e-4  # fp32 custom backward vs torch's, of the max entry
# the NaN pattern at each of K4's tiers
CHOL_NAN_N = (20, 40, 70)
# the card's published peaks (H100 SXM, 700 W): HBM bytes/s, fp32 FLOP/s
# on the CUDA cores, TF32 FLOP/s on the tensor cores (dense)
HBM_BYTES_S, FP32_FLOP_S, TF32_FLOP_S = 3.35e12, 67e12, 495e12
PPCA_N, PPCA_Q, PPCA_D, PPCA_S = 2048, 64, 128, 4
PPCA_STEPS, PPCA_LR, PPCA_FS, PPCA_JITTER = 20, 0.02, 16, 1e-3
# the MVN path through K4's block tier (64 < Q <= 128): log-pdf stacks of
# S·N = 2048 matrices of 128²
PPCA128_N, PPCA128_Q, PPCA128_STEPS = 512, 128, 5
PROFILE_STEPS = 10
# float32 (K4, IEEE products) vs float64 (plain) at the same state and
# draws: a sum of 2048·128 likelihood and 2048·64 latent terms
PPCA_F64_RTOL = 1e-4
# draws whitened by the float64 factor, pooled over s·N = 32768 vectors:
# the mean and the covariance's entries scatter by about 1/sqrt(32768)
PPCA_MOMENT_TOL = 8.0 / math.sqrt(PPCA_FS * PPCA_N)
# the exact GP: benchmarks/gp_exact_1k.py's configuration (N = 1024,
# D = 4, RBF, noise 0.1, Adam at lr 3e-2), 25 MAP steps
EXACT_N, EXACT_D, EXACT_STEPS, EXACT_LR = 1024, 4, 25, 3e-2
# float32 (K1, the fp32 Cholesky of K + 0.1·I) vs float64 (plain): the
# condition number of K + 0.1·I, about N·var/0.1 = 1e4, times fp32's eps
# (6e-8) bounds the quadratic term's relative error by about 6e-4, and
# random rounding stays far below that (an H100 gave 4.6e-6 here and up
# to 1.6e-5 for phase 16's grams)
EXACT_F64_RTOL = 1e-4
# the gradients of phase 16, relative to each gradient's largest entry:
# the same conditioning enters through K⁻¹ twice (an H100 gave 6.4e-5)
FAMILY_GRAD_RTOL = 1e-3
# the collapsed GP: N = 65536 rows of phase 6's data, M = 512, D = 32,
# full batch, MAP with Adam at lr 3e-3, 4 steps
SGP_N, SGP_STEPS, SGP_LR = 65536, 4, 3e-3
# float32 vs float64: the bound's −D·ΣKff/(2σ²) and +D·Σ(L⁻¹Kuf)²/(2σ²)
# are each about N·var/(2σ²) = 3.3e5 and nearly cancel; Σ(L⁻¹Kuf)²
# carries about cond(Kuu)·eps = 2e3 · 6e-8 = 1.2e-4 of relative error,
# some 40 in absolute terms against a loss of about 2e5, so 2e-4; the
# tolerance keeps 5x room and is no looser than 1e-3
SGP_F64_RTOL = 1e-3
# the bound pins the data tier at HIGHEST in both directions, so the
# TF32 data tier must leave its loss and gradient as they are
SGP_TIER_RTOL = 1e-6
# the mean-field slice (phases 18-21): BASELINE configs 1 and 2 under
# create_Gaussian_meanfield, S = 10 draws a step, 20 Adam steps; config 1
# at phase 9's widths and data, config 2 on the first 65536 rows of phase
# 6's data (D = 32)
MF_S, MF_STEPS, MF_LR = 10, 20, 0.02
LINREG_N = 65536
# float32 vs float64 at the same start and draws: sums of 2048·128
# likelihood terms (config 1) and 65536 (config 2) in fp32
MF_F64_RTOL = 1e-4
IWAE_S = 64
# BBVI against the pathwise gradient on S = 4096 fixed draws: both are
# unbiased for the same gradient, so their difference's mean lies within
# a few standard errors of 0 (five, over 32 coordinates)
BBVI_S, BBVI_SE = 4096, 5.0
# ADVI over constrained latents: three conjugate pairs, N = 65536
# observations drawn on the card, 400 Adam steps at lr 0.05 and 400 at
# 0.002 (at 0.05 alone the SVI noise keeps the Dirichlet's q some 3% off
# the posterior's mean, whose own spread is under 5%; a CPU run of this
# phase reached 0.7% after both); q's mean from 65536 draws of the
# fitted factor within 3% of the conjugate posterior's
ADVI_N, ADVI_K, ADVI_RTOL = 65536, 16, 0.03
ADVI_STEPS, ADVI_LR, ADVI_FINE_STEPS, ADVI_FINE_LR = 400, 0.05, 400, 0.002
# 2^20 draws of each distribution: means and variances within six
# standard errors of the closed forms (or of a float64 numpy pushforward)
MOMENT_DRAWS, MOMENT_SE = 1 << 20, 6.0
# the non-Gaussian SVGPs (phases 22-25): phase 6's rows and inputs
# (262144, D = 32), M = 512, B = 65536, Adam at lr 3e-3, float32, 20
# Gauss-Hermite points; the logit classifier runs two epochs (8 steps),
# every other model one (4 steps)
NG_LR, NG_Q, CLASS_EPOCHS = 3e-3, 20, 2
# float32 vs float64 at the same state and batch: the bound's var_f =
# Kff − Σ(L⁻¹Kuf)² + Σ(LsᵀL⁻¹Kuf)² cancels, and cond(Kuu) ≈ 1e3 times
# fp32's eps leaves about 1e-4 of each term; the loss, a sum over 65536
# points, lies some 10x inside
NG_F64_RTOL = 1e-3
# predictions vs float64 numpy on 256 rows (phase 4's tolerance)
NG_PRED_RTOL = 1e-3
MC_C, MC_K = 10, 8          # classes, MC draws a point a step
NB_DISPERSION = 0.5
PROB_SUM_ATOL = 1e-5
# the gamma draw's gradient: float32 on the card vs the ported
# random_gamma_grad in float64 on the CPU at the same draws
GAMMA_ALPHAS, GAMMA_N, GAMMA_RTOL = (0.1, 0.7, 2.0, 6.0, 50.0), 65536, 1e-5
# the rest of the GP module family (phases 27-31). LMC at
# benchmarks/lmc_scale.py:22's shape (Q latents, C outputs) on phase 6's
# rows; the deep GPs RBF(D) → DGP_H hidden → RBF(DGP_H) → 1, the hidden
# width min(30, D) as in Salimbeni & Deisenroth 2017, DGP_S propagation
# draws (the module's default) and DGP_SERVE_S served ones (the
# prediction's default)
LMC_Q, LMC_C = 8, 16
DGP_H, DGP_S, DGP_SERVE_S = 30, 5, 20
# served variances may cancel below 0 by this much (phase 4's limit)
VAR_ATOL = 1e-6
# natural gradients: benchmarks/svgp_1m.py:25-64's ngd mode (10^6 rows of
# its own data, d = 8, B = 4096, M = 256, γ = 0.1), Adam at lr 3e-3 on the
# hyperparameters; one epoch is 245 steps
NGD_N, NGD_D, NGD_B, NGD_M, NGD_GAMMA, NGD_LR = (
    1_000_000, 8, 4096, 256, 0.1, 3e-3)
# the γ = 1 step onto the collapsed bound at phase 15's configuration, in
# float64: tests/inference/test_natural_gradient.py:66-82 holds it to 1e-8
# at N = 60. At N = 65536 the data term of P = S⁻¹ + 2γ g_S/D, about
# N·var/σ² = 6.6e5, dwarfs S⁻¹, so the solve for the new S may lose up to
# cond(P)·eps of its relative accuracy; the loss takes that at second
# order (the step lands on a stationary point), and 1e-6 leaves room
NGD_ORACLE_RTOL = 1e-6
# phases 50-53 on the north star's configuration (benchmarks/svgp_1m.py,
# the NGD_ widths and its Adam lr 3e-3): the plain splitmix64 shuffle's
# size; k = 5 against k = 1 take the same 245 batches and steps, so their
# epoch losses differ only by the order of the mean over the epoch
SPLITMIX_N, NS_K5_RTOL = 4097, 1e-5
# remat recomputes the same kernels on the same inputs: the gradients may
# differ only where a reduction's order does (the fused K3 sums in a fixed
# order, the cuBLAS products may not), relative to each largest entry
REMAT_GRAD_TOL = 1e-6
# data parallel over a world of one: the minibatch epoch against phase
# 51's k = 5, BASELINE config 5 against BatchInferenceLoop, serving against
# the plain predictor (relative to the largest entry), HMC over shard_data
# against the unsharded chain
DP_RTOL, DP_NN_STEPS, DP_NN_RTOL = 1e-6, 20, 1e-5
DP_SERVE_ROWS, DP_SERVE_TOL, DP_HMC_DRAWS, DP_HMC_ATOL = (
    262144, 1e-6, 50, 1e-5)
# the model axis over a world of one: q(U) and Z placed over "model" of a
# 1 x 1 mesh, make_shard_map_step at the headline shape from phase 6's
# start against the replicated step (one rank gathers its own block, so
# the two steps run the same operations: bit-equality expected), then one
# step at benchmarks/model_axis_2d.py's M = 2048, D = 16, B = 4096
MA_STEPS, MA_LR, MA_RTOL = 4, 3e-3, 1e-6
MA_M, MA_D, MA_B = 2048, 16, 4096
# persistence (phases 32-34) at phase 6's configuration: a resume restores
# the float32 parameters and Adam's moments bit for bit and K2/K3 are
# deterministic, so the resumed losses match the uninterrupted run's to
# rounding; the loaded and the exported predictors serve phase 5's
# 262144-row request (32 chunks) at the serving tolerances of phase 4
RESUME_ROWS, RESUME_RTOL = 2 * TRAIN_B, 1e-6
SMALL_ROWS, SMALL_REPS = 128, 9
# functions and NN models (phases 35-38): a feature network in front of
# phase 6's SVGP, and BASELINE config 5 at benchmarks/bnn_vae_dp.py's
# widths
DK_HIDDEN = 64
# the network's gradient, fused arm vs materialized: K3 holds dXs to 2e-3
# of its largest entry, and the tanh layer's Jacobian passes it on
DK_GRAD_RTOL = 5e-3
NN_STEPS = 20
NN_F64_RTOL = 1e-4    # the mean-field tolerance (phases 18-19)
BNN_N, BNN_IN, BNN_H, BNN_S, BNN_LR = 8192, 8, 64, 4, 0.03
# the BNN's fit before its forward draws: runs of 500 steps, each with a
# fresh Adam. The first steps' gradients, of a loss near 2e7, hold Adam's
# second moment for thousands of steps: on an H100 one run of 3000 steps
# left the predictive mean 0.57 off sin(3 x0), six runs of 500 0.079
BNN_FIT_RUNS, BNN_FIT_STEPS, BNN_FS, BNN_FIT_ATOL = 8, 500, 100, 0.1
VAE_N, VAE_D, VAE_K, VAE_H, VAE_S, VAE_LR = 8192, 16, 4, 64, 3, 1e-2
# the MCMC samplers (phases 39-41): benchmarks/mcmc_throughput.py's
# Bayesian linear regression (N = 100 000, D = 32, noise variance 0.25,
# 8 chains; HMC and PT at L = 8 and eps0 = 0.01, PT at 6 temperatures,
# SGLD at B = 1024 with a constant step), kept draws cut to fit
MCMC_N, MCMC_D, MCMC_S2, MCMC_CHAINS = 100_000, 32, 0.25, 8
MCMC_L, MCMC_EPS0, MCMC_WARMUP, PT_TEMPS = 8, 0.01, 200, 6
HMC_DRAWS, PT_DRAWS, CHEES_DRAWS = 200, 200, 100
# the benchmark's SGLD step 1e-5 exceeds 2/lambda_max (lambda_max of the
# posterior precision is about N/0.25·(1 + sqrt(D/N))² = 4.1e5, so
# 2/lambda_max = 4.8e-6) and the chain diverges; 2.5e-6 contracts by
# about 0.5 a step, and 200 burn-in steps forget the prior draw
SGLD_B, SGLD_BENCH_STEP, SGLD_DIVERGE_STEPS = 1024, 1e-5, 300
SGLD_STEP, SGLD_BURNIN, SGLD_DRAWS = 2.5e-6, 200, 2000
# the mean of w against the closed form, per coordinate, in Monte-Carlo
# standard errors sd/sqrt(ESS). SGLD's are of its chains' average (they
# share every minibatch) and its bound is looser: a constant step biases
# its spread (by about eps·lambda/4 and the minibatch noise), and the ESS
# of one series of 2000 draws is itself uncertain
MCMC_SE, SGLD_SE = 6.0, 10.0
PROFILE_TRANSITIONS = 20
# phase 40: tests/inference/test_mcmc_over_modules.py:21-63's model on
# phase 14's data
GP_CHAINS, GP_WARMUP, GP_DRAWS, GP_L = 4, 150, 150, 8
SVGD_PARTICLES, GP_SVGD_ITERS = 16, 150
# phase 41: test_chees.py:49-86's design scaled to N = 65536, D = 32; SVGD
# card vs CPU in float32 from the same particles. float32 against float64
# on the CPU parted by 4.9e-7 at max |z| = 2.55 after 50 iterations, and
# the card's sums differ from the CPU's by the same fp32 rounding
CORR_N, CORR_WARMUP, CORR_DRAWS = 65536, 150, 50
SVGD_CPU_ITERS, SVGD_CPU_RTOL = 50, 1e-4
# the evidence and model-criticism layer (phases 42-45). Laplace on
# phase 39's BLR at the float64 mode: Σ within 1e-4 of its largest entry
# (H's fp32 entries of about N/σ² = 4e5 carry some 1e-6 relative error,
# which Σ = H⁻¹ takes at cond(H) ≈ 1.1), the log evidence, a float32 sum
# over 10^5 points of about -7e4, within 1e-5 relative
LAP_COV_TOL, LAP_BLR_RTOL = 1e-4, 1e-5
# over phase 14's GP: MAP (Adam, lr 3e-2) to the mode, then Laplace; the
# exact GP's agreement (cond(K + σ²I) ≈ 1e4 times fp32's eps) for the
# evidence, 1e-3 for the marginal variance, a second derivative
LAP_GP_STEPS, LAP_GP_LR, LAP_GP_RTOL, LAP_GP_VAR_RTOL = 500, 3e-2, 1e-4, 1e-3
# over phase 6's SVGP on its first 65536 rows: 4 full-batch MAP steps
# (the fused arm), then Laplace with the gate open; the SVGP's 1e-3
LAP_SVGP_N, LAP_SVGP_STEPS, LAP_SVGP_RTOL = 65536, 4, 1e-3
# thermodynamic integration over the GP: 2 chains x 16 rungs (c = 5),
# L = 8, sweeps cut from test_evidence.py's 400 + 600 to fit. The bound
# on |TI − Laplace|: the trapezoid's error on the steep part of the
# integrand, E_β[log L] ≈ ℓ* − 1/(2β) for one parameter, is about
# (h/β)³/12 ≈ (5/k)³/12 nats an interval from β_5 ≈ 4e-3 (where the
# likelihood, curvature about N/2 in log σ², overtakes the Gamma(2, 20)
# prior's 2) on: 0.07 + 0.04 + 0.02 + ... ≈ 0.2; the prior-dominated
# intervals below add some tenths; Monte-Carlo error about 0.1
TI_C, TI_K, TI_L, TI_WARMUP, TI_DRAWS, TI_ATOL = 2, 16, 8, 100, 200, 1.0
# test_evidence.py:21-41's Gamma-Exponential oracle and tolerances on the
# card, sweeps cut from 400 + 600
TI_GE_WARMUP, TI_GE_DRAWS, TI_GE_ATOL, TI_GE_RTOL = 150, 200, 0.15, 0.05
# model comparison on phase 39's BLR by SGLD (phase 39's step, B and
# burn-in), thinned to 200 draws a chain; the card's WAIC/LOO vs the
# port's own on the CPU on a column subset (float64 both)
MC_THIN, MC_DRAWS, MC_SUBSET, MC_CPU_RTOL, MC_MIS_D = 10, 200, 4096, 1e-9, 16
# masks on phase 39's BLR: 20% of y masked (set to 1e6); the masked and
# the subset objective are float32 sums of the same 8e4 terms in another
# order, and 20 Adam steps keep their losses within 1e-5
MASK_SHARE, MASK_OBJ_RTOL, MASK_STEPS, MASK_LR, MASK_STEP_RTOL = (
    0.2, 1e-6, 20, 1e-3, 1e-5)
# the state-space slice (phases 46-49). The Kalman ops at
# benchmarks/NOTES.md:356-375's shape: D = 4 latent states, E = 2
# observations, a stable A (0.9·I plus 0.05 N(0, 1) entries from the
# seed, its spectral radius checked below 1), Q = 0.05·I + 0.01,
# R = 0.1·I
KF_D, KF_E = 4, 2
KF_T_SHORT, KF_T_LONG, KF_T_PAR = 1024, 8192, 65536
KF_MASK_SHARE, KF_PAR_ROUNDS, KF_PROFILE_T = 0.3, 3, 256
# the sequential filter is host-bound (about 1.2 ms a step forward and
# 4.5 forward+backward on an H100's host): its forward+backward wall is
# taken at T = 1024 only, and at T = 8192 one batched forward filters
# the series and its masked copy together (the batch axis)
# float32 on the card against float64: the log-likelihood is a sum of T
# terms of about -1.5 nats, all of one sign. fp32's unit roundoff u =
# 6e-8 gives each term about cond(S)·u ≈ 1e-6 relative (S = H P Hᵀ + R
# is 2×2 with cond about 10); the filter forgets an error at the rate of
# A (ρ = 0.94), so the terms' errors do not pile up over time, and they
# are of both signs; the sum's own rounding is at most log2(T)·u ≈ 1e-6
# at T = 65536 (a tree reduction). 1e-5 leaves a margin of ten. The
# parallel filter's combines solve (I + CJ) systems of cond about 10 at
# log2(T) levels: the same order. The smoothers, sequential against
# parallel, within 1e-5 of the largest entry, by the same count.
KF_LL_RTOL, KF_SMOOTH_RTOL = 1e-5, 1e-5
# phase 47: the golden_ssm_map model (tests/goldens/configs.py:236-265,
# A a parameter from 0.5·I, MAP by Adam at lr 0.05) at phase 46's D = 4,
# E = 2 and data; the first loss against float64 at KF_LL_RTOL
SSM_PAR_T, SSM_PAR_STEPS, SSM_SEQ_T, SSM_SEQ_STEPS, SSM_LR = (
    65536, 20, 1024, 2, 0.05)
# phase 48: examples/stochastic_volatility.py's model at T = 2520 (ten
# years of daily returns), HMC with 2 chains and L = 16; warmup and
# draws cut from 500 + 500
SV_T, SV_CHAINS, SV_L, SV_WARMUP, SV_DRAWS = 2520, 2, 16, 100, 100
# phase 49: examples/pilco/pilco_example.py's configuration (n = 80,
# horizon 10, 4 samples), its fits cut from 300 and 150 steps; then a
# 4-state, 1-action linear system at the cart-pole widths of Deisenroth &
# Rasmussen 2011 (ICML): N = 1024 transitions, GPRegression with an RBF
# over the 5 inputs and Y (1024, 4), horizon 25, 64 samples. K1 against
# its plain version over one rollout at the exact GP's tolerances
PILCO_EX_N, PILCO_EX_DYN, PILCO_EX_POLICY, PILCO_EX_H, PILCO_EX_S = (
    80, 100, 40, 10, 4)
PILCO_N, PILCO_DS, PILCO_H, PILCO_S = 1024, 4, 25, 64
PILCO_DYN_STEPS, PILCO_POLICY_STEPS, PILCO_LR = 20, 5, 0.05


# phase 58: the keyed draws (R1, R2). Kernel against plain version at
# 2^20 elements of each gamma shape (GAMMA_ALPHAS) and Poisson rate,
# float32 and float64: equal to the bit, or within KEYED_RTOL relative
# with at most KEYED_FAR of the elements accepted in another round (the
# rounding of a comparison can flip it); means and variances within
# MOMENT_SE standard errors of the closed forms
KEYED_N, KEYED_RTOL, KEYED_FAR = 1 << 20, 1e-6, 1e-5
POISSON_RATES = (0.3, 4.0, 9.99, 10.0, 37.0, 1e4)
# the bound's operations: 88 32-bit integer operations a Threefry-2x32
# call and its uniform (5 x 4 rounds of add, rotate and xor; the key's
# injections; the shift, multiply-add and conversion of the uniform), and
# the floating-point operations of a round (a log, sqrt, cos or lgamma
# counted as one), at FP32_FLOP_S (the integer units' rate is lower: a
# generous bound) or, for float64's floating-point share, the H100 SXM's
# 34 TFLOP/s of fp64 outside the tensor cores (NVIDIA's data sheet)
HASH_OPS, GAMMA_ROUND_OPS, KNUTH_ROUND_OPS, PTRS_ROUND_OPS = 88, 24, 3, 27
FP64_FLOP_S = 34e12
# float64 gamma draws off the plain version, of KEYED_N at seed 0, as the
# kernels first measured them (PERF.md §6): boosted ones, whose pow is
# built here without FMA contraction and in torch with it. Each pow is
# within 2 ulps of the exact value (CUDA's double-precision library), so
# the two differ by up to 4 ulps and the draws, after the product's
# rounding, by up to GAMMA_F64_ULPS (representable doubles between them,
# by their bits; 2 measured at seed 0). The tile schedule moves no bit,
# so no shape may have more
GAMMA_F64_ULP_DRAWS, GAMMA_F64_ULPS = {0.1: 25, 0.7: 2}, 9
# the one-thread-an-element kernels' times at phase 58b's shapes on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6), printed beside this run's
ONE_THREAD_AN_ELEMENT_MS = {"R1": 0.10005, "R2": 0.00982}
# the slice at full width: phase 28's deep GP with the Student-t
# propagation of tests/test_torch_export.py (each normal draw n of the
# layers scaled by sqrt(2.5 / g), g ~ Gamma(2.5): a t with 5 degrees of
# freedom); a count predictor, X (n, 32) -> Linear(32, 64) -> tanh ->
# Linear(64, 1) -> softplus -> the mean of a NegativeBinomial with a
# learned dispersion, MAP on phase 24's counts for one epoch, its
# prediction drawing COUNT_S counts a row; the pooled variance of the
# served counts about the predicted means within COUNT_VAR_RTOL of the
# law's
STUDENT_T_SHAPE, COUNT_HIDDEN, COUNT_S, COUNT_VAR_RTOL = 2.5, 64, 20, 0.05


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


def ptxas_summary(lib_path):
    """Registers, static shared memory and spills of each kernel, from
    the ptxas report nvcc wrote beside the library."""
    log = lib_path.with_suffix(".log")
    out = []
    for ln in log.read_text().splitlines() if log.exists() else []:
        # a kernel's name, and its template arguments if it has them
        # (ILi64EE: <64>, ILb1EE: <true>, IfE: <f>, IfLi2EE: <f,2>)
        name = re.search(
            r"([a-z][a-z_]*[a-z]_kernel)(?:IL([ib])(\d+)EE|I([fd])E|"
            r"I([fd])Li(\d+)EE|E)", ln)
        if "Compiling entry function" in ln and name:
            kind, value = name.group(2), name.group(3) or name.group(4)
            if kind == "b":
                value = "true" if value == "1" else "false"
            if name.group(5):
                value = name.group(5) + "," + name.group(6)
            out.append(name.group(1) + ("<{}>".format(value)
                                        if value else "") + ":")
        elif "registers" in ln or "spill" in ln:
            out.append(ln.split(":", 1)[-1].strip())
    return " ".join(out)


def bound_ms(n_bytes, ops, flop_s):
    """The least time the card could take for a function: the larger of
    its bytes (each input read once, each output written once) over the
    HBM rate and its operations over their peak rate; in ms, with which
    of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / flop_s
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def rbf_bound(S, N, M, D, L):
    """K1: X, X2, the lengthscale and the variance read once and K (S, N,
    M) written once; fp32 operations on the CUDA cores: 2NMD for the
    cross term, 3(N + M)D for the scaling and the norms, 6NM for the
    epilogue."""
    n_bytes = 4 * S * (N * D + M * D + L + 1 + N * M)
    ops = S * (2 * N * M * D + 3 * (N + M) * D + 6 * N * M)
    return bound_ms(n_bytes, ops, FP32_FLOP_S)


def fused_bounds(n_rows, n_cols, n_feat):
    """K2 and K3 at ``lower=True`` (the bound's call), whose L⁻¹ input is
    its lower triangle. K2 reads it, Zs, Xs and the variance and writes
    G (M, N); its products run as 3-pass TF32 on the tensor cores: the
    G-product (M(M + 1)N) and the gram's cross term (2MND). K3 reads the
    same, dG and G, and writes dU (M, M), dZs, dXs and skv; its products
    are 1-pass TF32 (Uᵀ·dG and tril(dG·Kᵀ), M(M + 1)N each; de·Xs and
    deᵀ·Zs, 2MND each) beside the gram's 3-pass cross term."""
    Mr, N, Df = n_rows, n_cols, n_feat
    tri = Mr * (Mr + 1) // 2
    ins = tri + Mr * Df + N * Df + 1
    k2 = bound_ms(4 * (ins + Mr * N),
                  3 * (Mr * (Mr + 1) * N + 2 * Mr * N * Df), TF32_FLOP_S)
    k3 = bound_ms(4 * (ins + 2 * Mr * N + Mr * Mr + Mr * Df + N * Df + 1),
                  2 * Mr * (Mr + 1) * N + 4 * Mr * N * Df
                  + 3 * 2 * Mr * N * Df, TF32_FLOP_S)
    return k2, k3


def chol_bound(B, n):
    """K4 and K5: A read and L written once (8·B·n² bytes); B·n³/3 fp32
    operations."""
    return bound_ms(8 * B * n * n, B * n ** 3 / 3, FP32_FLOP_S)


def rbf_f64(A, B, ls, var):
    return var * np.exp(-0.5 * sq_dist_f64(A, B, ls))


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


def fused_inputs(rng, n_rows, n_cols, n_feat, dev, upper=0.0):
    """K2/K3 inputs as tests/ops/test_pallas_fused_gram.py makes them (a
    well-conditioned lower-triangular stand-in for L⁻¹, plus ``upper``
    times noise above the diagonal), with features scaled by the
    lengthscale sqrt(D) so that the gram is not all zeros."""
    import torch
    f32 = dict(dtype=torch.float32, device=dev)
    ls = math.sqrt(n_feat)
    A = rng.standard_normal((n_rows, n_rows))
    Linv = np.tril(A * 0.05) + np.eye(n_rows) + upper * np.triu(A, 1)
    return (torch.as_tensor(Linv, **f32),
            torch.as_tensor(rng.uniform(0, BOX, (n_rows, n_feat)) / ls, **f32),
            torch.as_tensor(rng.uniform(0, BOX, (n_cols, n_feat)) / ls, **f32),
            torch.tensor(1.4, **f32),
            torch.as_tensor(rng.standard_normal((n_rows, n_cols)) * 0.01,
                            **f32))


def check_fused(fused_gram, inputs, label, lower):
    """K2 and K3 against their plain versions on the card; K3 twice, for
    the same bits. Returns the largest absolute errors (K2, K3)."""
    import torch
    Linv, Zs, Xs, var, dG = inputs
    with torch.no_grad():
        G = fused_gram._fwd_cuda(Linv, Zs, Xs, var, lower)
        P = fused_gram._fused_fwd_torch(Linv, Zs, Xs, var, lower)
        first = fused_gram._bwd_cuda(Linv, Zs, Xs, var, dG, G, lower)
        second = fused_gram._bwd_cuda(Linv, Zs, Xs, var, dG, G, lower)
        plain = fused_gram._fused_bwd_torch(Linv, Zs, Xs, var, dG, lower)
    torch.cuda.synchronize()
    check(G.shape == P.shape and bool(torch.isfinite(G).all()),
          "{}: K2 output {} not finite or not {}".format(
              label, tuple(G.shape), tuple(P.shape)))
    fwd_err = float((G - P).abs().max())
    check(bool(((G - P).abs() <= FWD_ATOL + FWD_RTOL * P.abs()).all()),
          "{}: K2 vs plain max |diff| {} beyond rtol {} atol {}".format(
              label, fwd_err, FWD_RTOL, FWD_ATOL))
    bwd_err = 0.0
    rel = []
    for name, a, b, p in zip(("dU", "dZs", "dXs", "skv"), first, second,
                             plain):
        check(torch.equal(a, b), "{}: K3 {} differs between two calls"
              .format(label, name))
        err = float((a - p).abs().max())
        scale = max(float(p.abs().max()), 1e-30)
        check(bool(torch.isfinite(a).all()) and err <= BWD_RTOL * scale,
              "{}: K3 {} vs plain max |diff| {} > {} x {}".format(
                  label, name, err, BWD_RTOL, scale))
        bwd_err = max(bwd_err, err)
        rel.append("{} {:.2e}".format(name, err / scale))
    print("phase 3 kernel: {} M={} N={} D={} lower={}: K2 max_abs_err={:.3e}"
          " | K3 max_abs_err={:.3e}, relative to each max: {} | K3 bitwise "
          "deterministic".format(label, Zs.shape[0], Xs.shape[0],
                                 Zs.shape[1], lower, fwd_err, bwd_err,
                                 ", ".join(rel)), flush=True)
    return fwd_err, bwd_err


def plain_bwd_tf32(fused_gram, Linv, Zs, Xs, var, dG):
    """The plain backward under ``lower`` with its two M²N products
    (Uᵀ·dG, dG·Kᵀ) in TF32 on cuBLAS, the kernel's tier; the rest as
    the plain version computes it. For timing only."""
    import torch
    K = fused_gram._gram_torch(Zs, Xs, var)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        de = K * (torch.tril(Linv).T @ dG)
        dU = torch.tril(dG @ K.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    dZs = de @ Xs - torch.sum(de, dim=1)[:, None] * Zs
    dXs = de.T @ Zs - torch.sum(de, dim=0)[:, None] * Xs
    return dU, dZs, dXs, torch.sum(de)


def bound_at_singular_kuu(rng, X, Y, dev, read_counts):
    """The SVGP bound and its gradient at a Kuu that is not positive
    definite in float32: jitter 0 and a lengthscale 1e3 times the box, so
    that every entry of Kuu lies within 2e-5 of the variance, far below
    what a float32 factorization of a 512 × 512 matrix resolves. The
    fused arm runs (K2 once, K3 once). Returns the loss and the
    launches."""
    import torch
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import (GradBasedInference, MAP,
                                              create_executor)
    from mxfusion_tpu_torch.modules import SVGPRegression
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0,
                          lengthscale=1e3 * BOX),
        noise_var=m.noise_var, shape=(m.n, 1), jitter=0.0,
        inducing_inputs=Variable(shape=(M, D), initial_value=rng.uniform(
            0.0, BOX, (M, D))))
    alg = MAP(model=m, observed=[m.X, m.Y])
    inf = GradBasedInference(alg, dtype="float32", device=dev)
    Xb = torch.as_tensor(X[:TRAIN_B], device=dev)
    Yb = torch.as_tensor(Y[:TRAIN_B], device=dev)
    inf.initialize(X=Xb, Y=Yb)
    executor = create_executor(alg, inf.params)
    train = {k: v.clone().requires_grad_(True)
             for k, v in inf.params.trainable_params().items()}
    before = read_counts()
    loss = executor(train, inf.params.fixed_params(), [Xb, Yb], None)[1]
    loss.backward()
    torch.cuda.synchronize()
    after = read_counts()
    return float(loss.detach()), {k: after[k] - before[k] for k in after}


def broadcast_cases(dev, dtype, seed):
    """K1's route on inputs broadcast over s = 3 samples (stride-0 views,
    copied dense before the kernel): ``GaussianProcess.log_pdf`` of three
    samples of f at one X (40 x 3, ARD, jitter 1e-2), and an SVGP bound
    (N = 40, M = 8, D = 3) with three sampled noise variances in place of
    the stored one. Returns each value (float64 numpy) with the K1
    launches it made."""
    import torch
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import GaussianProcess
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import (
        GradBasedInference, MAP, RuntimeContext, VariableEnv, create_executor)
    from mxfusion_tpu_torch.modules import SVGPRegression
    from mxfusion_tpu_torch.ops import cuda_kernels
    from mxfusion_tpu_torch.util.carryover import load_state
    rng = np.random.default_rng(seed)
    out = []
    kern = RBF(input_dim=3, ARD=True)
    gp = GaussianProcess(X=0.0, kernel=kern, jitter=1e-2)
    gp._generate_outputs(shape=(40, 2))
    env = {gp.X.uuid: rng.random((1, 40, 3)) * 4,
           gp.random_variable.uuid: rng.standard_normal((3, 40, 2)),
           kern.lengthscale.uuid: rng.random((1, 3)) + 0.7,
           kern.variance.uuid: np.full((1, 1), 0.8)}
    before = cuda_kernels.rbf_kernel_matrix.launches
    with torch.no_grad():
        value = gp.log_pdf(VariableEnv({
            k: torch.as_tensor(v, dtype=getattr(torch, dtype), device=dev)
            for k, v in env.items()}))
    torch.cuda.synchronize()
    out.append((value.double().cpu().numpy(),
                cuda_kernels.rbf_kernel_matrix.launches - before))
    X = rng.random((40, 3)) * 4
    Y = np.sin(2 * X[:, :1]) + 0.1 * rng.standard_normal((40, 1))
    Z0 = rng.random((8, 3)) * 4
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, 3))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=3, variance=1.0, lengthscale=0.8,
                          dtype=dtype),
        noise_var=m.noise_var, shape=(m.n, 1), dtype=dtype,
        inducing_inputs=Variable(shape=Z0.shape, initial_value=Z0))
    inf = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]), dtype=dtype,
                             device=dev)
    inf.initialize(X=X, Y=Y)
    load_state(inf.params, {  # every entry: the same store in both dtypes
        "inducing_inputs": Z0, "noise_var": np.full(1, -2.0),
        "Y.rbf_lengthscale": np.full(1, 0.5),
        "Y.rbf_variance": np.full(1, 0.3),
        "Y.qU_mean": rng.standard_normal((8, 1)),
        "Y.qU_cov_W": 0.1 * rng.standard_normal((8, 8)),
        "Y.qU_cov_diag": np.full(8, -3.0)}, inf.graphs)
    p = inf.params
    ex = create_executor(inf.inference_algorithm, p)
    env = ex.build_env(p.trainable_params(), p.fixed_params(), [X, Y])
    env[m.noise_var.uuid] = p.as_tensor([[0.05], [0.1], [0.3]])
    before = cuda_kernels.rbf_kernel_matrix.launches
    with torch.no_grad():
        value = inf.inference_algorithm.compute(
            env, RuntimeContext(torch.Generator(dev)))[0]
    torch.cuda.synchronize()
    out.append((float(value),
                cuda_kernels.rbf_kernel_matrix.launches - before))
    return out


def loss_and_grad_at(alg, state, data, dtype, dev, grad=True,
                     rv_scaling=None, generator=None):
    """The loss of ``alg`` on ``data`` in ``dtype`` on ``dev``, at the
    trainable ``state`` ({uuid: unconstrained tensor}; None: the
    initialized store), with ``rv_scaling`` as the executor takes it,
    and with ``grad`` its gradient by uuid as float64 numpy; draws, if
    the algorithm makes any, take ``generator``. float64 takes the plain
    branch of every kernel."""
    import torch
    from mxfusion_tpu_torch.inference import (GradBasedInference,
                                              create_executor)
    tdtype = getattr(torch, dtype)
    data = [torch.as_tensor(d, device=dev).to(tdtype) for d in data]
    inf = GradBasedInference(alg, dtype=dtype, device=dev)
    inf.initialize(**dict(zip(alg.observed_variable_names, data)))
    if state is not None:
        inf.params.update_params({k: v.to(tdtype) for k, v in
                                  state.items()})
    executor = create_executor(alg, inf.params, rv_scaling=rv_scaling)
    train = {k: v.clone().requires_grad_(grad)
             for k, v in inf.params.trainable_params().items()}
    with torch.set_grad_enabled(grad):
        loss = executor(train, inf.params.fixed_params(), data,
                        generator)[1]
    if not grad:
        return float(loss), None
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: v.grad.double().cpu().numpy()
                                  for k, v in train.items()}


def refresh_posterior_cache(inf, data):
    """One evaluation of the log-pdf at the trained parameters, with its
    aux (the module's prediction cache) written into the store: the loop
    writes the cache at each step's parameters before the update."""
    import torch
    from mxfusion_tpu_torch.inference import create_executor
    executor = create_executor(inf.inference_algorithm, inf.params)
    with torch.no_grad():
        aux = executor(inf.params.trainable_params(),
                       inf.params.fixed_params(), data, None)[2]
    inf.params.update_params(aux)


def sq_dist_f64(A, B, ls):
    """Squared scaled distances in float64 numpy by the GEMM expansion
    (exact enough in float64, and no (N, M, D) temporary)."""
    A, B = A / ls, B / ls
    d = np.sum(A * A, 1)[:, None] + np.sum(B * B, 1)[None] - 2.0 * A @ B.T
    return np.maximum(d, 0.0)


def exact_gp_predict_f64(X, Y, ls, var, noise, Xt):
    """The exact GP's predictive mean and noise-free variance in float64
    numpy: K = k(X, X) + σ²I, μ = Kxtᵀ K⁻¹ y, v = var − diag(Kxtᵀ K⁻¹
    Kxt)."""
    K = rbf_f64(X, X, ls, var) + noise * np.eye(len(X))
    Kxt = rbf_f64(X, Xt, ls, var)
    sol = np.linalg.solve(K, np.concatenate([Y, Kxt], axis=1))
    return Kxt.T @ sol[:, :1], var - np.sum(Kxt * sol[:, 1:], axis=0)


def sparse_gp_predict_f64(X, Y, Z, ls, var, noise, jitter, Xt):
    """The collapsed GP's predictive mean and noise-free variance in
    float64 numpy (Titsias): L = chol(Kuu + jitter·I), A = L⁻¹Kuf,
    LA = chol(I + AAᵀ/σ²), w = L⁻ᵀLA⁻ᵀLA⁻¹AY/σ²; μ = Kxtᵀw and
    v = var − Σ(L⁻¹Kxt)² + Σ(LA⁻¹L⁻¹Kxt)²."""
    M = len(Z)
    L = np.linalg.cholesky(rbf_f64(Z, Z, ls, var) + jitter * np.eye(M))
    A = np.linalg.solve(L, rbf_f64(Z, X, ls, var))
    LA = np.linalg.cholesky(np.eye(M) + A @ A.T / noise)
    w = np.linalg.solve(L.T, np.linalg.solve(
        LA.T, np.linalg.solve(LA, A @ Y))) / noise
    Kxt = rbf_f64(Z, Xt, ls, var)
    B = np.linalg.solve(L, Kxt)
    C = np.linalg.solve(LA, B)
    return Kxt.T @ w, var - np.sum(B * B, 0) + np.sum(C * C, 0)


def gp_model(module, kernel, d, noise=0.1, **kw):
    """``module`` (GPRegression, SparseGPRegression or SVGPRegression)
    over d inputs with ``kernel`` and a noise variance starting at
    ``noise``; returns the model and its MAP algorithm."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import MAP
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, d))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=noise)
    m.Y = module.define_variable(X=m.X, kernel=kernel,
                                 noise_var=m.noise_var, shape=(m.n, 1), **kw)
    return m, MAP(model=m, observed=[m.X, m.Y])


def make_training_data(rng):
    """benchmarks/svgp_common.py's data at D = 32: X uniform on the box,
    y = sin(2 x0) + 0.3 cos(3 x1) + 0.1 noise, float32."""
    X = rng.uniform(0.0, BOX, (TRAIN_N, D)).astype(np.float32)
    f = np.sin(2.0 * X[:, :1]) + 0.3 * np.cos(3.0 * X[:, 1:2])
    Y = (f + 0.1 * rng.standard_normal((TRAIN_N, 1))).astype(np.float32)
    return X, Y


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


def spd_stack(rng, B, n, dev):
    """A float32 stack of SPD matrices W·Wᵀ + n·I on ``dev``."""
    import torch
    W = rng.standard_normal((B, n, n)).astype(np.float32)
    A = W @ np.swapaxes(W, -1, -2) + n * np.eye(n, dtype=np.float32)
    return torch.as_tensor(A, device=dev)


def check_cholesky(bc, A, label):
    """K4 and K5 against the plain version on one stack: error relative
    to max |L| of the float64 factor, the upper triangle exactly 0, the
    same bits over two calls; K4's custom gradient against
    ``torch.linalg.cholesky``'s. Returns {kernel: max |kernel − plain|}
    and a printable summary."""
    import torch
    from mxfusion_tpu_torch.ops import linalg
    B, n, _ = A.shape
    ref = linalg.cholesky(A.double())
    plain = linalg.cholesky(A)
    scale = float(ref.abs().max())
    errs, notes = {}, []
    for name, wrapper in (("K4", bc._k4_cuda), ("K5", bc._k5_cuda)):
        with torch.no_grad():
            first, second = wrapper(A), wrapper(A)
        torch.cuda.synchronize()
        rel = float((first.double() - ref).abs().max()) / scale
        check(bool(torch.isfinite(first).all()) and rel <= CHOL_RTOL,
              "{} {}: {} vs float64 max |diff| / max |L| = {} > {}".format(
                  label, name, tuple(A.shape), rel, CHOL_RTOL))
        check(bool((torch.triu(first, 1) == 0).all()),
              "{} {}: upper triangle not exactly 0".format(label, name))
        check(torch.equal(first, second), "{} {}: two calls differ".format(
            label, name))
        errs[name] = float((first - plain).abs().max())
        notes.append("{} rel {:.2e}".format(name, rel))
    G = torch.as_tensor(np.random.default_rng(B * n).standard_normal(
        (B, n, n)), dtype=torch.float32, device=A.device)
    grads = []
    for fn in (bc.batched_cholesky, torch.linalg.cholesky):
        a = A.clone().requires_grad_(True)
        torch.sum(fn(a) * G).backward()
        grads.append(a.grad + a.grad.transpose(-1, -2))
    grad_rel = float((grads[0] - grads[1]).abs().max()
                     / grads[1].abs().max())
    check(grad_rel <= CHOL_GRAD_RTOL, "{}: K4 custom gradient vs "
          "torch.linalg.cholesky's: {} > {}".format(label, grad_rel,
                                                   CHOL_GRAD_RTOL))
    notes.append("grad rel {:.2e}".format(grad_rel))
    return errs, "{} B={} n={}: {}".format(label, B, n, ", ".join(notes))


def posterior_covariance(A):
    """q(z_n)'s covariance A_n·A_nᵀ + 1e-3·I."""
    import torch
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.matmul(A, A.transpose(-1, -2)) + PPCA_JITTER * eye


def build_ppca(n, q_dim, d, W0, rand_gens=None, dtype="float32"):
    """Structured PPCA through the port's public API: z_n ~ N(0, I) in
    precision form, x = z·W + noise, and q(z_n) = N(q_mu_n, q_A_n
    q_A_nᵀ + 1e-3·I), a full-covariance posterior. ``rand_gens``
    optionally fixes the noise of q's draw ("q"). Returns (model,
    posterior)."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.models import Posterior
    from mxfusion_tpu_torch.components.distributions import (
        MultivariateNormal, MultivariateNormalMeanPrecision, Normal)
    from mxfusion_tpu_torch.components.functions import Function
    from mxfusion_tpu_torch.components.functions.operators import (
        broadcast_to, dot)
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    gens = rand_gens or {}
    m = Model()
    m.zero = Variable(value=0.)
    m.eye = Variable(value=np.eye(q_dim))
    m.W = Variable(shape=(q_dim, d), initial_value=W0)
    # every variable named: the float64 check loads states by name path
    m.z_mean = broadcast_to(m.zero, (n, q_dim))
    m.z_precision = broadcast_to(m.eye, (n, q_dim, q_dim))
    m.z = MultivariateNormalMeanPrecision.define_variable(
        mean=m.z_mean, precision=m.z_precision, shape=(n, q_dim),
        dtype=dtype)
    m.noise = Variable(transformation=PositiveTransformation(),
                       initial_value=1.0)
    m.x_mean = dot(m.z, m.W)
    m.x_variance = broadcast_to(m.noise, (n, d))
    m.x = Normal.define_variable(mean=m.x_mean, variance=m.x_variance,
                                 shape=(n, d), dtype=dtype)
    q = Posterior(m)
    q.q_mu = Variable(shape=(n, q_dim))
    q.q_A = Variable(shape=(n, q_dim, q_dim),
                     initial_value=np.tile(0.5 * np.eye(q_dim), (n, 1, 1)))
    q.q_cov = Function(posterior_covariance, input_names=["A"],
                       output_names=["cov"], broadcastable=True)(q.q_A)
    q.z.set_prior(MultivariateNormal(mean=q.q_mu, covariance=q.q_cov,
                                     rand_gen=gens.get("q"), dtype=dtype))
    return m, q


def ppca_data(rng, n, q_dim, d):
    """z and x from a true PPCA (x = z·W + 0.5·noise), and W's start."""
    W = rng.standard_normal((q_dim, d))
    z = rng.standard_normal((n, q_dim))
    x = z @ W + 0.5 * rng.standard_normal((n, d))
    return x.astype(np.float32), 0.1 * rng.standard_normal((q_dim, d))


def ppca_loss_at(state, x, noise, W0, dtype, dev):
    """The negative ELBO at the name-path ``state`` on q-draws fixed to
    ``noise``, in ``dtype`` (float64 runs the plain Cholesky)."""
    import torch
    from mxfusion_tpu_torch.components.distributions import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.inference import (
        GradBasedInference, StochasticVariationalInference)
    n, d = x.shape
    m, q = build_ppca(n, W0.shape[0], d, W0, dtype=dtype,
                      rand_gens={"q": FixedRandomGenerator(noise)})
    return loss_at(GradBasedInference(StochasticVariationalInference(
        num_samples=PPCA_S, model=m, posterior=q, observed=[m.x]),
        dtype=dtype, device=dev), state, {"x": x}, dev)


def loaded(inf, state, data):
    """``inf`` initialized on ``data`` (by observed variable name) and
    set to the name-path ``state``."""
    from mxfusion_tpu_torch.util.carryover import load_state
    inf.initialize(**data)
    load_state(inf.params, {k: v.double().cpu().numpy()
                            for k, v in state.items()}, inf.graphs)
    return inf


def loss_at(inf, state, data, dev):
    """The loss of ``inf``'s algorithm at the name-path ``state``."""
    import torch
    from mxfusion_tpu_torch.inference import create_executor
    inf = loaded(inf, state, data)
    ex = create_executor(inf.inference_algorithm, inf.params)
    with torch.no_grad():
        return float(ex(inf.params.trainable_params(),
                        inf.params.fixed_params(), observed_data(inf, data),
                        torch.Generator(dev))[0])


def observed_data(inf, data):
    """``data`` by observed variable name, in the algorithm's order."""
    return [data[v.name] for v in inf.inference_algorithm.observed_variables]


def whitened_moments(z, mu, L):
    """Draws z (s, N, Q) of N(mu_n, L_n L_nᵀ) whitened, w = L_n⁻¹(z − mu_n),
    pooled over samples and points: the largest |mean| and the largest
    |cov − I| entry of w (0 for exact draws; about 1/sqrt(s·N) apart by
    chance)."""
    import torch
    w = torch.linalg.solve_triangular(
        L, (z - mu)[..., None], upper=False)[..., 0].reshape(
            -1, z.shape[-1]).double()
    mean = w.mean(0)
    cov = torch.cov(w.T)
    eye = torch.eye(z.shape[-1], dtype=w.dtype, device=w.device)
    return float(mean.abs().max()), float((cov - eye).abs().max())


def recording_loop(loop_cls, read_counts):
    """``loop_cls`` (a minibatch loop) recording each step's loss, kernel
    launches and wall time (synchronized before and after), and the first
    batch."""
    import torch

    class RecordingLoop(loop_cls):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.losses, self.counts, self.wall_s = [], [], []
            self.first_batch = None

        def _step(self, executor, opt, trainable, fixed, batch, generator,
                  grad_norm=False):
            if self.first_batch is None:
                self.first_batch = batch
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._step(executor, opt, trainable, fixed, batch,
                                generator, grad_norm)
            torch.cuda.synchronize()
            self.wall_s.append(time.perf_counter() - t0)
            after = read_counts()
            self.counts.append({k: after[k] - before[k] for k in after})
            self.losses.append(out[0])
            return out

    return RecordingLoop


def recording_batch_loop(read_counts, sync):
    """A ``BatchInferenceLoop`` that records each step's loss, kernel
    launches and wall time (synchronized before and after), and the
    trainable state the first step starts from."""
    from mxfusion_tpu_torch.inference import BatchInferenceLoop

    class RecordingBatchLoop(BatchInferenceLoop):
        def __init__(self):
            super().__init__()
            self.losses, self.counts, self.wall_s = [], [], []
            self.start_state = None

        def _step(self, executor, opt, trainable, fixed, batch, generator,
                  grad_norm=False):
            if self.start_state is None:
                self.start_state = {k: v.detach().clone()
                                    for k, v in trainable.items()}
            before = read_counts()
            sync()
            t0 = time.perf_counter()
            out = BatchInferenceLoop._step(self, executor, opt, trainable,
                                           fixed, batch, generator,
                                           grad_norm)
            sync()
            self.wall_s.append(time.perf_counter() - t0)
            after = read_counts()
            self.counts.append({k: after[k] - before[k] for k in after})
            self.losses.append(float(out[0]))
            return out

    return RecordingBatchLoop()


def train_ppca(dev, seed, n, q_dim, d, steps, read_counts, sync):
    """Structured-PPCA SVI through ``GradBasedInference`` (S = 4 samples,
    Adam): returns the trained inference, the data, W's start, the start
    state by name path and the recording loop."""
    from mxfusion_tpu_torch.inference import (
        GradBasedInference, StochasticVariationalInference)
    x, W0 = ppca_data(np.random.default_rng(seed), n, q_dim, d)
    m, q = build_ppca(n, q_dim, d, W0)
    inf, loop, start = train_recorded(
        lambda loop: GradBasedInference(StochasticVariationalInference(
            num_samples=PPCA_S, model=m, posterior=q, observed=[m.x]),
            grad_loop=loop, dtype="float32", device=dev),
        {"x": x}, steps, PPCA_LR, dev, seed, read_counts, sync)
    return inf, x, W0, start, loop


def train_recorded(make_inference, data, steps, lr, dev, seed,
                   read_counts, sync):
    """``steps`` Adam steps of ``make_inference(loop)`` through a
    recording loop: returns the inference, the loop and the start state
    by name path."""
    import torch
    from mxfusion_tpu_torch.util.carryover import name_paths
    loop = recording_batch_loop(read_counts, sync)
    inf = make_inference(loop)
    inf.run(max_iter=steps, learning_rate=lr,
            generator=torch.Generator(dev).manual_seed(seed), **data)
    paths = name_paths(inf.graphs)
    return inf, loop, {paths[k]: v for k, v in loop.start_state.items()}


def profile_steps(make_inference, data, steps, lr, trace_path,
                  generator=None):
    """``steps`` training steps of ``make_inference(grad_loop)`` under
    ``torch.profiler`` (CPU and CUDA activities), after two steps to warm
    up, with no synchronization added. From the Chrome trace: the
    recorded window's wall, the device's busy time in it (the union of
    kernel, copy and set intervals) and the device time by kernel name;
    None if the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from mxfusion_tpu_torch.inference import BatchInferenceLoop
    prof = None

    class SteppingLoop(BatchInferenceLoop):
        def _step(self, *args, **kwargs):
            out = BatchInferenceLoop._step(self, *args, **kwargs)
            prof.step()
            return out

    inf = make_inference(SteppingLoop())
    Path(trace_path).parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=steps),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     str(trace_path))) as prof:
        inf.run(max_iter=steps + 2, learning_rate=lr, generator=generator,
                **data)
    torch.cuda.synchronize()
    events = [e for e in json.loads(Path(trace_path).read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    marks = [e for e in events
             if str(e.get("name", "")).startswith("ProfilerStep#")]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        return None
    span = marks or device
    return device_busy(device, min(e["ts"] for e in span),
                       max(e["ts"] + e["dur"] for e in span))


def device_busy(device, t0, t1):
    """From a Chrome trace's device events: the window's wall, the
    device's busy time in it (the union of the events' intervals) and
    the device time by kernel name, in ms, as :func:`profile_steps`
    returns them."""
    busy, end = 0.0, t0
    by_name = {}
    for e in sorted(device, key=lambda e: e["ts"]):
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], t1)
        if b > a:
            busy += b - a
            end = b
        # "void ns::(anonymous namespace)::kernel<...>(...)" -> "kernel"
        name = re.sub(r"^void |\(anonymous namespace\)::", "",
                      str(e["name"]))
        name = re.split(r"[(<]", name)[0].split("::")[-1][:40].strip() \
            or "(unnamed)"
        by_name[name] = by_name.get(name, 0.0) + e["dur"]
    return (t1 - t0) / 1e3, busy / 1e3, sorted(
        by_name.items(), key=lambda kv: -kv[1])


def profile_window(fn, trace_path):
    """``fn()`` under ``torch.profiler`` in one annotated range, the
    device synchronized before the range closes: :func:`device_busy` over
    that range, or None if the trace holds no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    Path(trace_path).parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_window"):
            fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = [e for e in json.loads(Path(trace_path).read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    (mark,) = [e for e in events if e.get("name") == "chip_smoke_window"
               and e.get("cat") == "user_annotation"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        return None
    return device_busy(device, mark["ts"], mark["ts"] + mark["dur"])


def profile_ppca(dev, seed, steps, trace_path):
    """Structured-PPCA SVI steps under ``torch.profiler``
    (:func:`profile_steps`)."""
    import torch
    from mxfusion_tpu_torch.inference import (
        GradBasedInference, StochasticVariationalInference)
    x, W0 = ppca_data(np.random.default_rng(seed), PPCA_N, PPCA_Q, PPCA_D)
    m, q = build_ppca(PPCA_N, PPCA_Q, PPCA_D, W0)
    return profile_steps(
        lambda loop: GradBasedInference(StochasticVariationalInference(
            num_samples=PPCA_S, model=m, posterior=q, observed=[m.x]),
            grad_loop=loop, dtype="float32", device=dev),
        {"x": x}, steps, PPCA_LR, trace_path,
        generator=torch.Generator(dev).manual_seed(seed))


def profile_summary(prof, steps):
    """The window, busy time, idle share and top kernels of a
    :func:`profile_steps` result, as one line's text."""
    if prof is None:
        return "the trace holds no device events: device time not measured"
    wall_ms, busy_ms, by_name = prof
    return "window {:.3f} ms ({:.3f} per step), device busy {:.3f} ms " \
        "({:.3f} per step), idle share {:.1%} | device time by kernel: " \
        "{}".format(wall_ms, wall_ms / steps, busy_ms, busy_ms / steps,
                    1 - busy_ms / wall_ms,
                    " | ".join("{} {:.3f} ms".format(k, v / 1e3)
                               for k, v in by_name[:8]))


def sample_ppca(inf, seed):
    """``VariationalPosteriorForwardSampling`` of the trained posterior
    and ``ForwardSampling`` of the prior, PPCA_FS draws of (z, x) each."""
    import torch
    from mxfusion_tpu_torch.inference import (
        ForwardSampling, VariationalPosteriorForwardSampling)
    m = inf.inference_algorithm.model
    gen = torch.Generator(inf.params.device).manual_seed(seed)
    post = VariationalPosteriorForwardSampling(
        num_samples=PPCA_FS, observed=[], inherited_inference=inf,
        target_variables=[m.z, m.x])
    prior = ForwardSampling(num_samples=PPCA_FS, model=m, observed=[],
                            infr_params=inf.params,
                            target_variables=[m.z, m.x])
    return post.run(generator=gen), prior.run(generator=gen)


def meanfield_ppca(n, q_dim, d, W0, dtype="float32"):
    """BASELINE config 1 (tests/goldens/configs.py:48-77) at phase 9's
    widths: z_n ~ N(0, I), x = z·w + noise, w starting at W0. The
    priors' inputs are unnamed: the name paths of ``util.carryover``
    tell them apart. Returns (model, observed)."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import Normal
    from mxfusion_tpu_torch.components.functions.operators import (
        broadcast_to, dot)
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    m = Model()
    m.w = Variable(shape=(q_dim, d), initial_value=W0)
    m.z = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (n, q_dim)),
        variance=broadcast_to(Variable(value=1.), (n, q_dim)),
        shape=(n, q_dim), dtype=dtype)
    m.noise = Variable(transformation=PositiveTransformation(),
                       initial_value=1.0)
    m.x = Normal.define_variable(mean=dot(m.z, m.w),
                                 variance=broadcast_to(m.noise, (n, d)),
                                 shape=(n, d), dtype=dtype)
    return m, [m.x]


def meanfield_linreg(n, d, dtype="float32"):
    """BASELINE config 2 (tests/goldens/configs.py:80-111): w ~ N(0, I)
    in R^(d x 1), y = X·w + noise with a learned noise variance.
    Returns (model, observed)."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import Normal
    from mxfusion_tpu_torch.components.functions.operators import (
        broadcast_to, dot)
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    m = Model()
    m.X = Variable(shape=(n, d))
    m.w = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (d, 1)),
        variance=broadcast_to(Variable(value=1.), (d, 1)),
        shape=(d, 1), dtype=dtype)
    m.noise = Variable(transformation=PositiveTransformation(),
                       initial_value=1.0)
    m.y = Normal.define_variable(mean=dot(m.X, m.w),
                                 variance=broadcast_to(m.noise, (n, 1)),
                                 shape=(n, 1), dtype=dtype)
    return m, [m.X, m.y]


def posterior_latents(q):
    from mxfusion_tpu_torch.components.variables import VariableType
    return [v for v in q.variables.values()
            if v.type == VariableType.RANDVAR]


def meanfield_inference(build, algorithm, S, dev, dtype="float32",
                        grad_loop=None, noise=None):
    """``GradBasedInference(algorithm)`` over ``build(dtype)``'s model
    and its ``create_Gaussian_meanfield`` posterior, whose draws are
    ``noise`` when it is given."""
    from mxfusion_tpu_torch.components.distributions import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.inference import (GradBasedInference,
                                              create_Gaussian_meanfield)
    m, observed = build(dtype)
    q = create_Gaussian_meanfield(model=m, observed=observed, dtype=dtype)
    if noise is not None:
        for v in posterior_latents(q):
            v.factor._rand_gen = FixedRandomGenerator(noise)
    return GradBasedInference(
        algorithm(num_samples=S, model=m, posterior=q, observed=observed),
        grad_loop=grad_loop, dtype=dtype, device=dev)


def meanfield_loss_at(build, state, data, S, noise, dtype, dev,
                      algorithm=None):
    """The loss of ``algorithm`` (default SVI) at the name-path ``state``
    on posterior draws fixed to ``noise``, in ``dtype`` on ``dev``."""
    from mxfusion_tpu_torch.inference import StochasticVariationalInference
    return loss_at(meanfield_inference(
        build, algorithm or StochasticVariationalInference, S, dev, dtype,
        noise=noise), state, data, dev)


def train_meanfield(build, data, S, steps, lr, dev, seed, read_counts,
                    sync, algorithm=None):
    """:func:`train_recorded` of ``algorithm`` (default SVI) over
    ``build``'s mean-field model."""
    from mxfusion_tpu_torch.inference import StochasticVariationalInference
    return train_recorded(
        lambda loop: meanfield_inference(
            build, algorithm or StochasticVariationalInference, S, dev,
            grad_loop=loop), data, steps, lr, dev, seed, read_counts, sync)


def wall_summary(wall_s, listed=True):
    """Median and quartiles (ms) of the step walls after the first, and
    the walls themselves (``listed``) or their count."""
    q1, med, q3 = np.percentile(1e3 * np.asarray(wall_s[1:]), [25, 50, 75])
    return "median {:.3f} (quartiles {:.3f}-{:.3f}) of {}".format(
        med, q1, q3, [round(1e3 * w, 3) for w in wall_s] if listed
        else len(wall_s))


def per_sample_mean_gradients(inf, data, dev):
    """The gradient of ``inf``'s differentiated loss in q's mean, per
    sample: each draw gets its own copy of the mean in the env, and the
    loss averages over the draws, so S times the copy's gradient is the
    draw's own term. (S, ...) of the posterior's single latent."""
    import torch
    from mxfusion_tpu_torch.inference import RuntimeContext, create_executor
    alg = inf.inference_algorithm
    (v,) = posterior_latents(alg.posterior)
    mean = dict(v.factor.inputs)["mean"]
    env = create_executor(alg, inf.params).build_env(
        inf.params.trainable_params(), inf.params.fixed_params(),
        observed_data(inf, data))
    S = alg.num_samples
    copies = env[mean].detach().expand(
        (S,) + tuple(env[mean].shape[1:])).clone().requires_grad_(True)
    env[mean] = copies
    _, loss_for_grad = alg.compute(env, RuntimeContext(torch.Generator(dev)))
    loss_for_grad.backward()
    return copies.grad * S


def advi_pairs(dev, seed):
    """The three conjugate pairs of phase 21, N = ADVI_N observations
    drawn on the card: (label, model builder, data, the latent's name,
    the expected factor family, the conjugate posterior's mean)."""
    import torch
    from mxfusion_tpu_torch import Model
    from mxfusion_tpu_torch.components.distributions import (
        Bernoulli, Beta, Categorical, Dirichlet, Exponential, Gamma)
    from mxfusion_tpu_torch.components.functions.operators import (
        broadcast_to, log)
    g = torch.Generator(dev).manual_seed(seed)
    n, k = ADVI_N, ADVI_K
    y_exp = torch.empty((n, 1), device=dev).exponential_(generator=g) / 1.7
    y_ber = (torch.rand((n, 1), generator=g, device=dev) < 0.3).float()
    p_true = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
    p_true = p_true / p_true.sum()
    y_cat = torch.multinomial(p_true, n, replacement=True,
                              generator=g).float()[:, None]

    def gamma_exponential(dtype):
        m = Model()
        m.tau = Gamma.define_variable(alpha=2.0, beta=2.0, shape=(1,),
                                      dtype=dtype)
        m.y = Exponential.define_variable(
            rate=broadcast_to(m.tau, (n, 1)), shape=(n, 1), dtype=dtype)
        return m, [m.y]

    def beta_bernoulli(dtype):
        m = Model()
        m.p = Beta.define_variable(alpha=2.0, beta=2.0, shape=(1,),
                                   dtype=dtype)
        m.y = Bernoulli.define_variable(
            prob_true=broadcast_to(m.p, (n, 1)), shape=(n, 1), dtype=dtype)
        return m, [m.y]

    def dirichlet_categorical(dtype):
        m = Model()
        m.p = Dirichlet.define_variable(alpha=np.full(k, 2.0), shape=(k,),
                                        dtype=dtype)
        m.y = Categorical.define_variable(
            log_prob=log(broadcast_to(m.p, (n, k))), num_classes=k,
            shape=(n, 1), dtype=dtype)
        return m, [m.y]

    counts = torch.bincount(y_cat[:, 0].long(), minlength=k).double()
    return [
        ("Gamma-Exponential", gamma_exponential, {"y": y_exp}, "tau",
         "LogNormal", ((2.0 + n) / (2.0 + y_exp.double().sum()))[None]),
        ("Beta-Bernoulli", beta_bernoulli, {"y": y_ber}, "p", "LogitNormal",
         ((2.0 + y_ber.double().sum()) / (4.0 + n))[None]),
        ("Dirichlet-Categorical (K={})".format(k), dirichlet_categorical,
         {"y": y_cat}, "p", "StickBreakingNormal",
         (2.0 + counts) / (2.0 * k + n))]


def stick_breaking_f64(z):
    """ops/simplex.py's forward in float64 numpy: R^(..., K-1) -> the
    K-simplex, with the offsets log(K-1-k)."""
    k1 = z.shape[-1]
    v = 1.0 / (1.0 + np.exp(-(z - np.log(np.arange(k1, 0, -1)))))
    rem = np.concatenate([np.ones(z.shape[:-1] + (1,)),
                          np.cumprod(1.0 - v, axis=-1)], axis=-1)
    return np.concatenate([v * rem[..., :-1], rem[..., -1:]], axis=-1)


def moment_cases(rng, n):
    """(name, class name, parameters, event shape, closed-form mean and
    variance, or None and a float64 numpy sample of the same law)."""
    k = 4
    alpha = np.array([0.5, 1.0, 2.0, 4.0])
    a0 = alpha.sum()
    probs = np.arange(1, 17) / np.arange(1, 17).sum()
    idx = np.arange(16)
    cat_mean = float((idx * probs).sum())
    sb_mean, sb_var = np.array([0.3, -0.5, 0.1]), np.array([0.4, 0.2, 0.9])
    return [
        ("LogNormal", "LogNormal", {"mean": 0.2, "variance": 0.25}, (1,),
         (np.exp(0.325), (np.exp(0.25) - 1) * np.exp(0.65)), None),
        ("LogitNormal", "LogitNormal", {"mean": 0.3, "variance": 0.5}, (1,),
         None, 1.0 / (1.0 + np.exp(-(0.3 + np.sqrt(0.5)
                                      * rng.standard_normal((n, 1)))))),
        ("StickBreakingNormal (K=4)", "StickBreakingNormal",
         {"mean": sb_mean, "variance": sb_var}, (k,), None,
         stick_breaking_f64(sb_mean + np.sqrt(sb_var)
                            * rng.standard_normal((n, k - 1)))),
        ("Gamma", "Gamma", {"alpha": 2.5, "beta": 1.5}, (1,),
         (2.5 / 1.5, 2.5 / 1.5 ** 2), None),
        ("GammaMeanVariance", "GammaMeanVariance",
         {"mean": 2.0, "variance": 0.5}, (1,), (2.0, 0.5), None),
        ("Exponential", "Exponential", {"rate": 2.0}, (1,), (0.5, 0.25),
         None),
        ("InverseGamma (alpha=6)", "InverseGamma",
         {"alpha": 6.0, "beta": 2.0}, (1,),
         (2.0 / 5.0, 4.0 / (25.0 * 4.0)), None),
        ("Beta", "Beta", {"alpha": 2.0, "beta": 3.0}, (1,),
         (0.4, 6.0 / (25.0 * 6.0)), None),
        ("Bernoulli", "Bernoulli", {"prob_true": 0.3}, (1,), (0.3, 0.21),
         None),
        ("Dirichlet (K=4)", "Dirichlet", {"alpha": alpha}, (k,),
         (alpha / a0, alpha / a0 * (1 - alpha / a0) / (a0 + 1)), None),
        ("Categorical (K=16), index", "Categorical",
         {"log_prob": np.log(probs)}, (1,),
         (cat_mean, float(((idx - cat_mean) ** 2 * probs).sum())), None)]


def moment_check(x, closed, ref):
    """Largest |mean - expected| and |variance - expected| over the
    event's entries, each in standard errors of the draws (of both
    samples against a pushforward)."""
    x = x.reshape(x.shape[0], -1)
    n = x.shape[0]
    mean, var = x.mean(0), x.var(0)
    m4 = ((x - mean) ** 4).mean(0)
    if closed is not None:
        e_mean, e_var = (np.asarray(c, dtype=np.float64).reshape(-1)
                         for c in closed)
        se_mean = np.sqrt(e_var / n)
        se_var = np.sqrt((m4 - var ** 2) / n)
    else:
        r = ref.reshape(ref.shape[0], -1)
        e_mean, e_var = r.mean(0), r.var(0)
        r4 = ((r - e_mean) ** 4).mean(0)
        se_mean = np.sqrt(var / n + e_var / r.shape[0])
        se_var = np.sqrt((m4 - var ** 2) / n + (r4 - e_var ** 2) / r.shape[0])
    return (float(np.max(np.abs(mean - e_mean) / se_mean)),
            float(np.max(np.abs(var - e_var) / se_var)))


def draw_moments(dev, seed, cases):
    """MOMENT_DRAWS draws of each distribution of ``cases`` on the card's
    generator, float32, against the closed forms: [(name, mean z,
    variance z)]. A case's optional seventh entry maps the draws to what
    its closed form describes."""
    import torch
    from mxfusion_tpu_torch.components import distributions as dists
    from mxfusion_tpu_torch.components.variables import Variable
    out = []
    for i, (name, cls, params, shape, closed, ref, *post) in enumerate(
            cases):
        inputs = {p: Variable() for p in params}
        kw = {"num_classes": 16} if cls == "Categorical" else {}
        dist = getattr(dists, cls)(dtype="float32", **kw, **inputs)
        dist._generate_outputs(shape=shape)
        env = {inputs[p].uuid: torch.as_tensor(
            np.reshape(v, (1,) + (np.shape(v) or (1,))),
            dtype=torch.float32, device=dev) for p, v in params.items()}
        gen = torch.Generator(dev).manual_seed(seed + i)
        with torch.no_grad():
            x = dist.draw_samples(env, gen, num_samples=MOMENT_DRAWS)
        check(x.device.type == torch.device(dev).type
              and x.dtype == torch.float32
              and tuple(x.shape) == (MOMENT_DRAWS,) + shape,
              "{} draws: {} {} {}".format(name, x.device, x.dtype,
                                          tuple(x.shape)))
        x = x.double().cpu().numpy()
        if post:
            x = post[0](x)
        z_mean, z_var = moment_check(x, closed, ref)
        check(z_mean <= MOMENT_SE and z_var <= MOMENT_SE,
              "{}: {} draws' mean {:.2f} and variance {:.2f} standard "
              "errors off (tol {})".format(name, MOMENT_DRAWS, z_mean, z_var,
                                           MOMENT_SE))
        out.append((name, z_mean, z_var))
    return out


def meanfield_phases(dev, card, seed, X, Y, x_ppca, W0, read_counts,
                     zero_counts, sync):
    """Phases 18-21: mean-field SVI (BASELINE configs 1 and 2), IWAE,
    BBVI against the pathwise gradient, and ADVI over constrained
    latents with the draws of every distribution of the slice. No
    kernel of K1-K5 lies on this path: each training run must launch
    none. Returns the R1/R2 launches of phase 21's draws."""
    import torch
    from mxfusion_tpu_torch.inference import (
        ImportanceWeightedVariationalInference, ScoreFunctionInference,
        ScoreFunctionRBInference, StochasticVariationalInference,
        create_executor)
    from mxfusion_tpu_torch.util.carryover import name_paths
    t_start = time.perf_counter()
    none = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    configs = {
        18: ("mean-field PPCA (config 1): N={} Q={} D={}".format(
            x_ppca.shape[0], W0.shape[0], x_ppca.shape[1]),
            lambda dtype: meanfield_ppca(x_ppca.shape[0], W0.shape[0],
                                         x_ppca.shape[1], W0, dtype),
            {"x": x_ppca}, W0.shape[0] * x_ppca.shape[0]),
        19: ("mean-field linear regression (config 2): N={} D={}".format(
            LINREG_N, X.shape[1]),
            lambda dtype: meanfield_linreg(LINREG_N, X.shape[1], dtype),
            {"X": X[:LINREG_N], "y": Y[:LINREG_N]}, X.shape[1])}
    trained = {}
    for phase, (label, build, data, n_latent) in configs.items():
        zero_counts()
        inf, loop, start = train_meanfield(build, data, MF_S, MF_STEPS,
                                           MF_LR, dev, seed + phase,
                                           read_counts, sync)
        sync()
        launches = read_counts()
        check(launches == none, "{}: launched {}; this path has no kernel"
              .format(label, launches))
        losses = loop.losses
        check(len(losses) == MF_STEPS
              and all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0],
              "{}: losses do not fall: {}".format(label, losses))
        noise = np.random.default_rng(seed + phase).standard_normal(
            MF_S * n_latent)
        l32 = meanfield_loss_at(build, start, data, MF_S, noise, "float32",
                                dev)
        l64 = meanfield_loss_at(build, start, data, MF_S, noise, "float64",
                                dev)
        rel = abs(l32 - l64) / abs(l64)
        check(rel <= MF_F64_RTOL, "{}: first loss float32 {} vs float64 {}: "
              "relative {}".format(label, l32, l64, rel))
        extra = ""
        if phase == 19:
            # IWAE at S = 64 and the ELBO on the same 64 draws (Jensen)
            noise64 = np.random.default_rng(seed + 64).standard_normal(
                IWAE_S * n_latent)
            elbo = -meanfield_loss_at(build, start, data, IWAE_S, noise64,
                                      "float32", dev)
            iwae = -meanfield_loss_at(
                build, start, data, IWAE_S, noise64, "float32", dev,
                ImportanceWeightedVariationalInference)
            check(math.isfinite(iwae) and iwae >= elbo, "IWAE bound {} < "
                  "ELBO {} on the same {} draws".format(iwae, elbo, IWAE_S))
            extra = " | IWAE bound at S={} {:.8g} >= ELBO {:.8g} on the " \
                "same draws".format(IWAE_S, iwae, elbo)
        trained[phase] = (build, data, n_latent, inf)
        print("phase {} {}, S={}, {} Adam steps (lr {}) | launches {} | "
              "losses {:.6g} -> {:.6g} | first loss on fixed draws float32 "
              "{:.8g} vs float64 {:.8g}: rel {:.3e} (tol {:.0e}){} | step "
              "wall ms ({}): {}".format(
                  phase, label, MF_S, MF_STEPS, MF_LR, launches, losses[0],
                  losses[-1], l32, l64, rel, MF_F64_RTOL, extra, card,
                  wall_summary(loop.wall_s)), flush=True)

    # ---- 18/19 profile (information): the two SVI steps' idle share
    profiles = []
    for phase in (18, 19):
        build, data, _, _ = trained[phase]
        prof = profile_steps(
            lambda loop, build=build: meanfield_inference(
                build, StochasticVariationalInference, MF_S, dev,
                grad_loop=loop),
            data, PROFILE_STEPS, MF_LR,
            ROOT / "build" / "chip_smoke_meanfield_{}_trace.json".format(
                phase),
            generator=torch.Generator(dev).manual_seed(seed))
        profiles.append("phase {}: {}".format(
            phase, profile_summary(prof, PROFILE_STEPS)))
    print("phase 18-19 profile ({}): {} SVI steps each under "
          "torch.profiler | {}".format(card, PROFILE_STEPS,
                                       " | ".join(profiles)), flush=True)

    # ---- 20. BBVI: both score-function estimators against the pathwise
    # gradient on the same S = 4096 draws, then 20 steps of each
    build, data, n_latent, inf19 = trained[19]
    noise = np.random.default_rng(seed + 20).standard_normal(
        BBVI_S * n_latent)
    state = {name_paths(inf19.graphs)[k]: v.detach()
             for k, v in inf19.params.param_dict.items()}

    def mean_gradients(algorithm):
        inf = loaded(meanfield_inference(build, algorithm, BBVI_S, dev,
                                         noise=noise), state, data)
        return per_sample_mean_gradients(inf, data, dev).double().reshape(
            BBVI_S, -1)

    pathwise = mean_gradients(StochasticVariationalInference)
    bbvi = []
    for algorithm in (ScoreFunctionInference, ScoreFunctionRBInference):
        g = mean_gradients(algorithm)
        diff = g - pathwise
        z = float((diff.mean(0).abs()
                   / (diff.std(0) / math.sqrt(BBVI_S))).max())
        rel = float((g.mean(0) - pathwise.mean(0)).norm()
                    / pathwise.mean(0).norm())
        name = algorithm.__name__
        check(z <= BBVI_SE, "{}: gradient in q's mean {} standard errors "
              "from the pathwise one (tol {})".format(name, z, BBVI_SE))
        zero_counts()
        _, loop, _ = train_meanfield(build, data, MF_S, MF_STEPS, MF_LR,
                                     dev, seed + 20, read_counts, sync,
                                     algorithm)
        launches = read_counts()
        check(launches == none and len(loop.losses) == MF_STEPS
              and all(math.isfinite(v) for v in loop.losses),
              "{}: {} steps gave {} (launches {})".format(
                  name, MF_STEPS, loop.losses, launches))
        bbvi.append("{}: max |mean difference| {:.2f} standard errors "
                    "(tol {}), relative {:.3e}; {} steps (S={}) losses "
                    "{:.6g} -> {:.6g}, step wall ms {}".format(
                        name, z, BBVI_SE, rel, MF_STEPS, MF_S,
                        loop.losses[0], loop.losses[-1],
                        wall_summary(loop.wall_s)))
    print("phase 20 bbvi ({}): gradient in q(w)'s mean at S={} fixed "
          "draws against the pathwise (SVI) gradient | {}".format(
              card, BBVI_S, " | ".join(bbvi)), flush=True)

    # ---- 21. ADVI over constrained latents; draws of every distribution
    advi = []
    for label, build, data, latent, family, post_mean in advi_pairs(
            dev, seed + 21):
        zero_counts()
        inf, loop, _ = train_meanfield(build, data, MF_S, ADVI_STEPS,
                                       ADVI_LR, dev, seed + 21, read_counts,
                                       sync)
        inf.run(max_iter=ADVI_FINE_STEPS, learning_rate=ADVI_FINE_LR,
                generator=torch.Generator(dev).manual_seed(seed + 22),
                **data)
        check(read_counts() == none, "{}: launched {}".format(
            label, read_counts()))
        alg = inf.inference_algorithm
        factor = getattr(alg.posterior, latent).factor
        check(type(factor).__name__ == family, "{}: the mean-field factor "
              "is {}, not {}".format(label, type(factor).__name__, family))
        env = create_executor(alg, inf.params).build_env(
            inf.params.trainable_params(), inf.params.fixed_params(),
            observed_data(inf, data))
        with torch.no_grad():
            draws = factor.draw_samples(
                env, torch.Generator(dev).manual_seed(seed),
                num_samples=ADVI_N)
        q_mean = draws.double().mean(0).reshape(-1)
        err = float(((q_mean - post_mean.to(q_mean.device)).abs()
                     / post_mean.to(q_mean.device)).max())
        check(err <= ADVI_RTOL and all(math.isfinite(v)
                                       for v in loop.losses),
              "{}: q's mean {} vs the conjugate posterior's {}: relative "
              "{} > {}".format(label, q_mean.tolist(), post_mean.tolist(),
                               err, ADVI_RTOL))
        advi.append("{}: {}, q's mean vs conjugate max rel {:.3e} (tol "
                    "{}), step wall median {:.3f} ms".format(
                        label, family, err, ADVI_RTOL,
                        1e3 * float(np.median(loop.wall_s[1:]))))
    zero_counts()
    moments = draw_moments(dev, seed + 22, moment_cases(
        np.random.default_rng(seed + 22), MOMENT_DRAWS))
    keyed = read_keyed()
    print("phase 21 advi ({}): N={}, {} Adam steps at lr {} and {} at {} "
          "each | {} | {} draws on the card's generator, max |mean| and "
          "|variance| error in standard errors (tol {}): {}; R1/R2 "
          "launches {} | phases 18-21 took {:.1f} s".format(
              card, ADVI_N, ADVI_STEPS, ADVI_LR, ADVI_FINE_STEPS,
              ADVI_FINE_LR, " | ".join(advi),
              MOMENT_DRAWS, MOMENT_SE, ", ".join(
                  "{} {:.2f} {:.2f}".format(*m) for m in moments), keyed,
              time.perf_counter() - t_start), flush=True)
    return keyed


def nongaussian_model(module, Z0, columns=1, **kw):
    """``module`` (a non-Gaussian SVGP class) over D = 32 inputs with an
    RBF kernel of lengthscale sqrt(D) and M inducing points at ``Z0``;
    returns the model and its MAP algorithm."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.inference import MAP
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.Y = module.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0,
                          lengthscale=math.sqrt(D)),
        shape=(m.n, columns),
        inducing_inputs=Variable(shape=(M, D), initial_value=Z0), **kw)
    return m, MAP(model=m, observed=[m.X, m.Y])


def train_nongaussian(loop_cls, m, alg, X, Y, epochs, dev, seed):
    """``epochs`` epochs of MAP + Adam through the recording device loop
    at B = TRAIN_B: returns the trained inference, the loop and the start
    state ({uuid: tensor})."""
    import torch
    from mxfusion_tpu_torch.inference import GradBasedInference
    loop = loop_cls(batch_size=TRAIN_B, rv_scaling={m.Y: TRAIN_N / TRAIN_B})
    inf = GradBasedInference(alg, grad_loop=loop, dtype="float32",
                             device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    inf.initialize(X=X[:TRAIN_B], Y=Y[:TRAIN_B], generator=gen)
    start = {k: v.detach().clone() for k, v in inf.params.param_dict.items()}
    inf.run(X=X, Y=Y, max_iter=epochs, learning_rate=NG_LR, generator=gen)
    return inf, loop, start


def rekeyed(state, graphs, to_graphs):
    """``state`` ({uuid of ``graphs``: value}) keyed by the uuids of the
    same variables in ``to_graphs``, matched by name path."""
    from mxfusion_tpu_torch.util.carryover import name_paths
    paths = name_paths(graphs)
    to = {p: u for u, p in name_paths(to_graphs).items()}
    return {to[paths[k]]: v for k, v in state.items()}


def check_steps(label, loop, per_step):
    """Every step of a recorded run launched ``per_step`` ({kernel:
    count}, the rest 0) and every loss is finite; returns the losses."""
    want = dict({"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}, **per_step)
    for i, counts in enumerate(loop.counts):
        check(counts == want, "{} step {} launched {}; expected {}".format(
            label, i, counts, want))
    losses = [float(v) for v in loop.losses]
    check(all(math.isfinite(v) for v in losses),
          "{}: non-finite losses {}".format(label, losses))
    return losses


def checked_run(label, loop, start, alg, dev):
    """Check a recorded training run: K1 twice (Kuu, Kuf) and nothing
    else each step, finite losses, and the first loss against the float64
    bound (plain gram) at the start state and the first batch. Returns
    the first loss's relative error and its float64 value."""
    losses = check_steps(label, loop, {"K1": 2})
    f64 = loss_and_grad_at(alg, start, loop.first_batch, "float64", dev,
                           grad=False, rv_scaling={
                               alg.model.Y.uuid: TRAIN_N / TRAIN_B})[0]
    rel = abs(losses[0] - f64) / abs(f64)
    check(rel <= NG_F64_RTOL, "{}: first loss float32 {} vs float64 {}: "
          "relative {} > {}".format(label, losses[0], f64, rel, NG_F64_RTOL))
    return rel, f64


def q_moments_f64(params, m, X, whitened):
    """Diagonal q(f) moments at X in float64 numpy from the trained store
    (svgp_classification.py's _layer_q_moments, relative jitter)."""
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.util.carryover import name_paths
    sp = PositiveTransformation().transform
    state = {p: params.param_dict[u].detach().double().cpu()
             for u, p in name_paths([m]).items() if u in params.param_dict}
    pos = {k: sp(state[k]).numpy() for k in ("Y.rbf_lengthscale",
                                             "Y.rbf_variance",
                                             "Y.qU_cov_diag")}
    Z = state["inducing_inputs"].numpy()
    ls, var = pos["Y.rbf_lengthscale"], float(pos["Y.rbf_variance"][0])
    W = state["Y.qU_cov_W"].numpy()
    mu = state["Y.qU_mean"].numpy()
    jitter = m.Y.factor.jitter
    Kuu = rbf_f64(Z, Z, ls, var)
    Kuu = Kuu + np.eye(M) * jitter * np.mean(np.diag(Kuu))
    L = np.linalg.cholesky(Kuu)
    Ls = np.linalg.cholesky(W @ W.T + np.diag(pos["Y.qU_cov_diag"]))
    if whitened:
        LinvLs, Linvmu = Ls, mu
    else:
        LinvLs, Linvmu = np.linalg.solve(L, Ls), np.linalg.solve(L, mu)
    LinvKuf = np.linalg.solve(L, rbf_f64(Z, X, ls, var))
    mu_f = LinvKuf.T @ Linvmu
    var_f = var - np.sum(LinvKuf ** 2, 0) + np.sum((LinvLs.T @ LinvKuf) ** 2,
                                                   0)
    return mu_f, np.maximum(var_f, 1e-14)


def class_probability_f64(mu, var, link):
    """p(y=1) in float64 numpy: Φ(μ/√(1+σ²)) for probit, the 20-point
    Gauss-Hermite mean of the logistic for logit."""
    if link == "probit":
        erf = np.frompyfunc(math.erf, 1, 1)
        z = mu / np.sqrt(1.0 + var)
        return 0.5 * (1.0 + erf(z / math.sqrt(2.0)).astype(np.float64))
    t, w = np.polynomial.hermite.hermgauss(NG_Q)
    f = mu[:, None] + np.sqrt(2.0 * var)[:, None] * t
    return (w / np.sqrt(np.pi) / (1.0 + np.exp(-f))).sum(-1)


def new_moment_cases(rng, n):
    """Phase 26's laws: (name, class name, parameters, event shape,
    closed-form mean and variance, None[, a map of the draws])."""
    w, mus, vs = np.array([0.3, 0.7]), np.array([-2.0, 1.0]), \
        np.array([0.5, 2.0])
    mix_mean = float(w @ mus)
    p = np.array([0.1, 0.2, 0.3, 0.4])
    A = rng.standard_normal((8, 8))
    S = (A @ A.T + 8.0 * np.eye(8)) / 16.0
    dof = 12.0
    return [
        ("Laplace", "Laplace", {"location": 0.5, "scale": 1.5}, (1,),
         (0.5, 4.5), None),
        ("StudentT (nu=5)", "StudentT",
         {"degrees_of_freedom": 5.0, "location": 0.5, "scale": 2.0}, (1,),
         (0.5, 4.0 * 5.0 / 3.0), None),
        ("Uniform", "Uniform", {"low": -1.0, "high": 3.0}, (1,),
         (1.0, 16.0 / 12.0), None),
        ("Poisson", "Poisson", {"rate": 3.5}, (1,), (3.5, 3.5), None),
        ("NegativeBinomial", "NegativeBinomial",
         {"mean": 3.0, "dispersion": 0.5}, (1,), (3.0, 7.5), None),
        # the argmax of a Concrete draw is class k with probability p_k
        ("Concrete (K=4, argmax)", "Concrete", {"probs": p}, (4,),
         (p, p * (1 - p)), None,
         lambda x: np.eye(4)[x.reshape(-1, 4).argmax(-1)]),
        ("NormalMixture (K=2)", "NormalMixture",
         {"weights": w, "means": mus, "variances": vs}, (1,),
         (mix_mean, float(w @ (vs + mus ** 2)) - mix_mean ** 2), None),
        ("Wishart (D=8, n=12)", "Wishart",
         {"degrees_of_freedom": dof, "scale": S}, (8, 8),
         (dof * S, dof * (S ** 2 + np.outer(np.diag(S), np.diag(S)))),
         None)]


def gamma_gradient_check(dev, seed):
    """dx/dalpha of GAMMA_N float32 gamma draws on the card at each of
    GAMMA_ALPHAS against ``random_gamma_grad`` in float64 on the CPU at
    the same draws: [(alpha, max relative error, iterations of the
    backward's series and continued fraction)]."""
    import torch
    from mxfusion_tpu_torch.components.distributions.random_gen import \
        RandomGenerator
    from mxfusion_tpu_torch.ops.igamma import random_gamma_grad
    tiny = torch.finfo(torch.float32).tiny
    out = []
    for i, a in enumerate(GAMMA_ALPHAS):
        alpha = torch.full((GAMMA_N,), a, device=dev, requires_grad=True)
        x = RandomGenerator().sample_gamma(
            torch.Generator(dev).manual_seed(seed + i), alpha=alpha,
            shape=(GAMMA_N,), dtype="float32")
        x.sum().backward()
        torch.cuda.synchronize()
        iterations = dict(random_gamma_grad.iterations)
        got = alpha.grad.double().cpu()
        xv = x.detach().double().cpu()
        want = random_gamma_grad(torch.full_like(xv, a), xv)
        normal = xv >= tiny   # subnormal float32 draws count as 0
        check(bool((got[~normal] == 0).all()) and bool(
            torch.isfinite(got).all()), "alpha={}: gradient at subnormal "
            "draws not 0, or not finite".format(a))
        rel = float(((got - want).abs() / want.abs())[normal].max())
        check(rel <= GAMMA_RTOL, "alpha={}: gamma draw gradient on the card "
              "{} relative off float64 (tol {})".format(a, rel, GAMMA_RTOL))
        out.append((a, rel, iterations, int((~normal).sum())))
    return out


def nongaussian_phases(dev, card, seed, X, read_counts, zero_counts, sync,
                       loop_cls):
    """Phases 22-26: SVGP classification (logit, unwhitened; probit,
    whitened), its serving, the count SVGPs (Poisson with both links,
    negative binomial with a learned dispersion), the multi-class SVGP,
    and the draws of the rest of the distribution library with the gamma
    draw's gradient. Returns the K1 launches of their main paths, the
    class labels, phase 24's counts and the R1/R2 launches of phase 26's
    draws (the gradient check's are not a main path's)."""
    import torch
    from mxfusion_tpu_torch.components.distributions import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.inference import (BatchedPredictor,
                                              GradBasedInference)
    from mxfusion_tpu_torch.modules import (
        SVGPClassification, SVGPMultiClassification,
        SVGPNegBinomialRegression, SVGPPoissonRegression)
    t_start = time.perf_counter()
    rng = np.random.default_rng(seed + 22)
    f = (np.sin(2.0 * X[:, :1]) + 0.3 * np.cos(3.0 * X[:, 1:2])).astype(
        np.float64)
    Z0 = rng.uniform(0.0, BOX, (M, D))
    k1 = 0

    # ---- 22. binary classification: logit unwhitened, probit whitened
    labels = (rng.random((TRAIN_N, 1)) < 1.0 / (1.0 + np.exp(-3.0 * f))
              ).astype(np.float32)
    cm, calg = nongaussian_model(SVGPClassification, Z0, link="logit",
                                 num_quadrature_points=NG_Q)
    zero_counts()
    cinf, cloop, cstart = train_nongaussian(loop_cls, cm, calg, X, labels,
                                            CLASS_EPOCHS, dev, seed + 22)
    sync()
    k1 += read_counts()["K1"]
    crel, c64 = checked_run("classification (logit)", cloop, cstart, calg,
                            dev)
    check(len(cloop.losses) == CLASS_EPOCHS * TRAIN_N // TRAIN_B,
          "classification ran {} steps".format(len(cloop.losses)))
    cprof = profile_steps(
        lambda loop: GradBasedInference(calg, grad_loop=loop,
                                        dtype="float32", device=dev),
        {"X": X[:TRAIN_B], "Y": labels[:TRAIN_B]}, PROFILE_STEPS, NG_LR,
        ROOT / "build" / "chip_smoke_classification_trace.json")
    pm, palg = nongaussian_model(SVGPClassification, Z0, link="probit",
                                 whitened=True, num_quadrature_points=NG_Q)
    zero_counts()
    pinf, ploop, pstart = train_nongaussian(loop_cls, pm, palg, X, labels,
                                            1, dev, seed + 23)
    sync()
    k1 += read_counts()["K1"]
    prel, p64 = checked_run("classification (probit, whitened)", ploop,
                            pstart, palg, dev)
    print("phase 22 classification ({}): {} rows, B={}, M={}, D={}, {} "
          "Gauss-Hermite points | logit, unwhitened (the wide arm), {} Adam "
          "steps (lr {}): K1 launches per step {} | losses {} | first loss "
          "float32 {:.8g} vs float64 {:.8g}: rel {:.3e} (tol {:.0e}) | step "
          "wall ms {} | profile: {} | probit, whitened, {} steps: losses {} "
          "| first loss vs float64 {:.8g}: rel {:.3e} | step wall ms {}"
          .format(card, TRAIN_N, TRAIN_B, M, D, NG_Q, len(cloop.losses),
                  NG_LR, cloop.counts[0]["K1"],
                  [round(float(v), 2) for v in cloop.losses],
                  float(cloop.losses[0]), c64, crel, NG_F64_RTOL,
                  wall_summary(cloop.wall_s),
                  profile_summary(cprof, PROFILE_STEPS), len(ploop.losses),
                  [round(float(v), 2) for v in ploop.losses], p64, prel,
                  wall_summary(ploop.wall_s)), flush=True)

    # ---- 23. classification serving: both trained stores
    bulk = X[:TRAIN_N]
    small = rng.uniform(0.0, BOX, (128, D)).astype(np.float32)
    serve_notes = []
    for label, m, inf, whitened, link in (
            ("logit", cm, cinf, False, "logit"),
            ("probit, whitened", pm, pinf, True, "probit")):
        pred = BatchedPredictor(model=m, infr_params=inf.params,
                                observed=[m.X], target_variables=[m.Y.uuid],
                                chunk_size=CHUNK)
        # the first request fixes the chunk: a full one
        pred.predict(X=bulk[:CHUNK])
        sync()
        zero_counts()
        t0 = time.perf_counter()
        p, pvar = pred.predict(X=bulk)[0]
        bulk_s = time.perf_counter() - t0
        bulk_k1 = read_counts()["K1"]
        t0 = time.perf_counter()
        ps, _ = pred.predict(X=small)[0]
        small_ms = 1e3 * (time.perf_counter() - t0)
        k1 += read_counts()["K1"]
        chunks = TRAIN_N // CHUNK + 1
        check(read_counts()["K1"] == 2 * chunks and bulk_k1 == 2 * (
            chunks - 1), "{}: serving launched K1 {} times for {} chunks; "
              "expected 2 per chunk".format(label, read_counts()["K1"],
                                           chunks))
        check(p.shape == pvar.shape == (1, TRAIN_N, 1)
              and ps.shape == (1, 128, 1) and np.isfinite(p).all()
              and p.min() > 0.0 and p.max() < 1.0,
              "{}: served probabilities {} not in (0, 1)".format(
                  label, p.shape))
        mu64, var64 = q_moments_f64(inf.params, m,
                                    bulk[:F64_ROWS].astype(np.float64),
                                    whitened)
        p64 = class_probability_f64(mu64[:, 0], var64, link)
        err = rel_err(p[0, :F64_ROWS, 0], p64)
        check(err <= NG_PRED_RTOL, "{}: served p vs float64 on {} rows: "
              "rel {} > {}".format(label, F64_ROWS, err, NG_PRED_RTOL))
        serve_notes.append(
            "{}: {} rows in {} chunks {:.1f} rows/s, K1 {} | 128-row "
            "request {:.3f} ms | vs float64 on {} rows rel {:.3e} (tol "
            "{:.0e})".format(label, TRAIN_N, chunks - 1, TRAIN_N / bulk_s,
                             bulk_k1, small_ms, F64_ROWS, err,
                             NG_PRED_RTOL))
    print("phase 23 classification serving ({}): chunk {} | {}".format(
        card, CHUNK, " | ".join(serve_notes)), flush=True)

    # ---- 24. the count SVGPs
    counts = rng.poisson(np.exp(f)).astype(np.float32)
    r = 1.0 / NB_DISPERSION
    nb_counts = rng.poisson(rng.gamma(r, np.exp(f) / r)).astype(np.float32)
    count_notes = []
    for label, module, Y, kw in (
            ("Poisson, log link", SVGPPoissonRegression, counts,
             dict(link="log")),
            ("Poisson, softplus link", SVGPPoissonRegression, counts,
             dict(link="softplus", num_quadrature_points=NG_Q)),
            ("negative binomial", SVGPNegBinomialRegression, nb_counts,
             dict(num_quadrature_points=NG_Q))):
        m, alg = nongaussian_model(module, Z0, **kw)
        zero_counts()
        inf, loop, start = train_nongaussian(loop_cls, m, alg, X, Y, 1,
                                             dev, seed + 24)
        sync()
        k1 += read_counts()["K1"]
        rel, l64 = checked_run(label, loop, start, alg, dev)
        extra = ""
        if module is SVGPNegBinomialRegression:
            extra = ", learned dispersion {:.4f}".format(
                float(inf.params[m.Y.factor.dispersion]))
        count_notes.append(
            "{}: K1 per step {}, losses {}, first loss vs float64 {:.8g} "
            "rel {:.3e}, step wall ms {}{}".format(
                label, loop.counts[0]["K1"],
                [round(float(v), 2) for v in loop.losses], l64, rel,
                wall_summary(loop.wall_s), extra))
    print("phase 24 counts ({}): B={}, M={}, D={}, 4 Adam steps each (tol "
          "{:.0e}) | {}".format(card, TRAIN_B, M, D, NG_F64_RTOL,
                                " | ".join(count_notes)), flush=True)

    # ---- 25. multi-class: C classes by the equal-count bins of f
    edges = np.quantile(f[:, 0], np.linspace(0, 1, MC_C + 1)[1:-1])
    onehot = np.eye(MC_C, dtype=np.float32)[np.searchsorted(edges, f[:, 0])]
    mm, malg = nongaussian_model(SVGPMultiClassification, Z0,
                                 columns=MC_C, num_classes=MC_C,
                                 num_mc_samples=MC_K)
    zero_counts()
    minf, mloop, mstart = train_nongaussian(loop_cls, mm, malg, X, onehot,
                                            1, dev, seed + 25)
    sync()
    k1 += read_counts()["K1"]
    # float32 vs float64 on fixed draws: the same model with a fixed
    # generator of TRAIN_B·C·K normals, the start state moved across by
    # name path
    noise = rng.standard_normal(TRAIN_B * MC_C * MC_K)
    fm, falg = nongaussian_model(SVGPMultiClassification, Z0,
                                 columns=MC_C, num_classes=MC_C,
                                 num_mc_samples=MC_K,
                                 rand_gen=FixedRandomGenerator(noise))
    fstate = rekeyed(mstart, malg.graphs, falg.graphs)
    fixed32 = loss_and_grad_at(
        falg, fstate, mloop.first_batch, "float32", dev, grad=False,
        rv_scaling={fm.Y.uuid: TRAIN_N / TRAIN_B},
        generator=torch.Generator(dev))[0]
    fixed64 = loss_and_grad_at(
        falg, fstate, mloop.first_batch, "float64", dev, grad=False,
        rv_scaling={fm.Y.uuid: TRAIN_N / TRAIN_B},
        generator=torch.Generator(dev))[0]
    mrel = abs(fixed32 - fixed64) / abs(fixed64)
    check(mrel <= NG_F64_RTOL, "multi-class first loss on fixed draws "
          "float32 {} vs float64 {}: rel {}".format(fixed32, fixed64, mrel))
    two_k1 = {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    check(all(c == two_k1 for c in mloop.counts)
          and all(math.isfinite(float(v)) for v in mloop.losses),
          "multi-class steps launched {}, losses {}".format(
              mloop.counts, mloop.losses))
    zero_counts()
    pred = BatchedPredictor(model=mm, infr_params=minf.params,
                            observed=[mm.X], target_variables=[mm.Y.uuid],
                            chunk_size=CHUNK)
    probs, _ = pred.predict(X=X[:CHUNK])[0]
    sync()
    k1 += read_counts()["K1"]
    sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
    check(probs.shape == (1, CHUNK, MC_C) and read_counts()["K1"] == 2
          and sum_err <= PROB_SUM_ATOL, "multi-class serving: shape {}, K1 "
          "{}, max |Σp − 1| {}".format(probs.shape, read_counts()["K1"],
                                       sum_err))
    print("phase 25 multi-class ({}): C={}, K={} draws ((1, {}, {}, {}) "
          "normals a step), B={}, M={}, {} Adam steps: K1 per step {} | "
          "losses {} | first loss on fixed draws float32 {:.8g} vs float64 "
          "{:.8g}: rel {:.3e} (tol {:.0e}) | step wall ms {} | served {} "
          "rows: max |sum p - 1| {:.3e} (tol {:.0e})".format(
              card, MC_C, MC_K, TRAIN_B, MC_C, MC_K, TRAIN_B, M,
              len(mloop.losses), mloop.counts[0]["K1"],
              [round(float(v), 2) for v in mloop.losses], fixed32, fixed64,
              mrel, NG_F64_RTOL, wall_summary(mloop.wall_s), CHUNK, sum_err,
              PROB_SUM_ATOL), flush=True)

    # ---- 26. the rest of the distribution library; the gamma gradient
    zero_counts()
    moments = draw_moments(dev, seed + 26, new_moment_cases(rng,
                                                            MOMENT_DRAWS))
    keyed = read_keyed()
    grads = gamma_gradient_check(dev, seed + 27)
    print("phase 26 draws ({}): {} draws each on the card's generator, max "
          "|mean| and |variance| error in standard errors (tol {}): {}; "
          "R1/R2 launches {} | gamma draw gradient, {} float32 draws per "
          "alpha vs float64 random_gamma_grad (tol {:.0e}): {} | phases "
          "22-26 took {:.1f} s"
          .format(card, MOMENT_DRAWS, MOMENT_SE, ", ".join(
              "{} {:.2f} {:.2f}".format(*mo) for mo in moments), keyed,
              GAMMA_N,
              GAMMA_RTOL, ", ".join(
                  "alpha {}: rel {:.3e}, iterations {} ({} subnormal draws)"
                  .format(a, rel, it, sub) for a, rel, it, sub in grads),
              time.perf_counter() - t_start), flush=True)
    return k1, labels, nb_counts, keyed


def deep_kuf_inputs(rng, dev):
    """The deep GP's inner-layer Kuf operands at phase 28's shapes: Z
    (1, M, DGP_H) on the box, DGP_S samples of propagated inputs
    (DGP_S, TRAIN_B, DGP_H) around points of the box, and the lengthscale
    sqrt(DGP_H) at s = 1."""
    import torch
    f32 = dict(dtype=torch.float32, device=dev)
    A = rng.uniform(0.0, BOX, (1, TRAIN_B, DGP_H)) \
        + 0.3 * rng.standard_normal((DGP_S, TRAIN_B, DGP_H))
    return (torch.as_tensor(rng.uniform(0.0, BOX, (1, M, DGP_H)), **f32),
            torch.as_tensor(A, **f32),
            torch.full((1, 1), math.sqrt(DGP_H), **f32))


def deep_gp_model(module, Z0s, **kw):
    """``module`` (DeepGPRegression or DeepGPClassification): RBF(D) →
    DGP_H hidden → RBF(DGP_H) → 1, lengthscales sqrt(width), M inducing
    points a layer at ``Z0s``, DGP_S propagation draws, whitened, the
    linear inner mean (the defaults); regression learns a noise variance
    from 0.1. Returns the model and its MAP algorithm."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import MAP
    from mxfusion_tpu_torch.modules import DeepGPRegression
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    if module is DeepGPRegression:
        m.noise_var = Variable(transformation=PositiveTransformation(),
                               initial_value=0.1)
        kw["noise_var"] = m.noise_var
    m.Y = module.define_variable(
        X=m.X, kernels=[RBF(input_dim=D, lengthscale=math.sqrt(D)),
                        RBF(input_dim=DGP_H, lengthscale=math.sqrt(DGP_H))],
        shape=(m.n, 1), num_samples=DGP_S,
        inducing_inputs=[Variable(shape=z.shape, initial_value=z)
                         for z in Z0s], **kw)
    return m, MAP(model=m, observed=[m.X, m.Y])


def state_by_path(params, graphs):
    """The trainable store of ``params`` by name path."""
    from mxfusion_tpu_torch.util.carryover import name_paths
    paths = name_paths(graphs)
    return {paths[k]: v.detach() for k, v in params.param_dict.items()}


def serve_timed(pred, X, small, sync, read_counts, zero_counts):
    """``pred`` (a BatchedPredictor whose first request fixed its chunk)
    answers ``X`` and the 128-row ``small``: (bulk outputs, bulk seconds,
    bulk K1 launches, small outputs, small ms, K1 launches of both)."""
    sync()
    zero_counts()
    t0 = time.perf_counter()
    out = pred.predict(X=X)[0]
    bulk_s = time.perf_counter() - t0
    bulk_k1 = read_counts()["K1"]
    t0 = time.perf_counter()
    out_small = pred.predict(X=small)[0]
    small_ms = 1e3 * (time.perf_counter() - t0)
    return out, bulk_s, bulk_k1, out_small, small_ms, read_counts()["K1"]


def fixed_draw_loss(module, Z0s, start, alg, batch, dev):
    """The deep GP bound at ``start`` (a state of ``alg``'s graphs) on
    ``batch``, float32 and float64, on one buffer of fixed normals (DGP_S
    draws of the hidden layer for every row)."""
    import torch
    from mxfusion_tpu_torch.components.distributions import \
        FixedRandomGenerator
    noise = np.random.default_rng(0).standard_normal(
        DGP_S * TRAIN_B * DGP_H)
    fm, falg = deep_gp_model(module, Z0s,
                             rand_gen=FixedRandomGenerator(noise))
    fstate = rekeyed(start, alg.graphs, falg.graphs)
    out = []
    for dtype in ("float32", "float64"):
        fm.Y.factor._rand_gen.reset()
        out.append(loss_and_grad_at(
            falg, fstate, batch, dtype, dev, grad=False,
            rv_scaling={fm.Y.uuid: TRAIN_N / TRAIN_B},
            generator=torch.Generator(dev))[0])
    return out[0], out[1], abs(out[0] - out[1]) / abs(out[1])


def fixed_draw_moments(module, Z0s, params, graphs, X, dev):
    """The served deep GP moments on ``X`` (F64_ROWS rows, one chunk) at
    the trained ``params``, float32 and float64, on one buffer of fixed
    normals (DGP_SERVE_S draws of the hidden layer for every row)."""
    from mxfusion_tpu_torch.components.distributions import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.inference import BatchedPredictor
    from mxfusion_tpu_torch.util.carryover import carryover_params
    noise = np.random.default_rng(1).standard_normal(
        DGP_SERVE_S * len(X) * DGP_H)
    fm, _ = deep_gp_model(module, Z0s, rand_gen=FixedRandomGenerator(noise))
    state = state_by_path(params, graphs)
    out = []
    for dtype in ("float32", "float64"):
        fm.Y.factor._rand_gen.reset()
        pred = BatchedPredictor(
            model=fm, observed=[fm.X], target_variables=[fm.Y.uuid],
            infr_params=carryover_params(state, [fm], dtype=dtype,
                                         device=dev),
            chunk_size=len(X))
        out.append(pred.predict(X=X)[0])
    return out


def gp_family_phases(dev, card, seed, X, Y, labels, read_counts,
                     zero_counts, sync, loop_cls):
    """Phases 27-31: LMC multi-output SVGP, deep GP regression and
    classification, natural-gradient SVGP training (minibatch against
    Adam, and the full-batch γ = 1 step onto the collapsed bound).
    Returns the launches of their main paths by kernel and phase 28's
    trained deep GP regression predictor."""
    import torch
    from mxfusion_tpu_torch import Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.inference import (
        BatchedPredictor, DeviceMinibatchLoop, GradBasedInference,
        NaturalGradientLoop, NaturalGradientMinibatchLoop)
    from mxfusion_tpu_torch.modules import (
        DeepGPClassification, DeepGPRegression, LMCSVGPRegression,
        SparseGPRegression, SVGPRegression)
    from mxfusion_tpu_torch.modules.gp_modules.lmc_svgp import \
        LMCSVGPMeanVariancePrediction
    t_start = time.perf_counter()
    launches = {"K1": 0, "K2": 0, "K3": 0}

    def add_launches():
        sync()
        for k in launches:
            launches[k] += read_counts()[k]

    small = np.random.default_rng(seed + 40).uniform(
        0.0, BOX, (128, D)).astype(np.float32)
    bulk = X[:TRAIN_B]
    chunks = TRAIN_B // CHUNK

    # ---- 27. LMC: C outputs mixed from Q latent functions of phase 6's
    # inputs, plus noise
    rng = np.random.default_rng(seed + 41)
    G = np.sin(2.0 * X @ (rng.standard_normal((D, LMC_Q)) / math.sqrt(D))
               + rng.uniform(0.0, 2.0 * math.pi, LMC_Q))
    Ylmc = (G @ rng.standard_normal((LMC_Q, LMC_C)) + 0.1
            * rng.standard_normal((TRAIN_N, LMC_C))).astype(np.float32)
    del G
    Z0 = rng.uniform(0.0, BOX, (M, D))
    lm, lalg = nongaussian_model(LMCSVGPRegression, Z0, columns=LMC_C,
                                 num_outputs=LMC_C, num_latents=LMC_Q)
    zero_counts()
    linf, lloop, lstart = train_nongaussian(loop_cls, lm, lalg, X, Ylmc, 1,
                                            dev, seed + 41)
    add_launches()
    lrel, l64 = checked_run("LMC", lloop, lstart, lalg, dev)
    # serving with the full cross-output covariance
    mod = lm.Y.factor
    mod.attach_prediction_algorithms(
        targets=mod.output_names, conditionals=mod.input_names,
        algorithm=LMCSVGPMeanVariancePrediction(
            mod._module_graph, mod._extra_graphs[0],
            [v for _, v in mod.inputs], full_output_cov=True,
            jitter=mod.jitter, whitened=mod.whitened),
        alg_name="lmc_svgp_predict")
    pred = BatchedPredictor(model=lm, infr_params=linf.params,
                            observed=[lm.X], target_variables=[lm.Y.uuid],
                            chunk_size=CHUNK)
    pred.predict(X=bulk[:CHUNK])
    (mean, cov), bulk_s, bulk_k1, (_, cs_), small_ms, k1 = serve_timed(
        pred, bulk, small, sync, read_counts, zero_counts)
    add_launches()
    check(bulk_k1 == 2 * chunks and k1 == 2 * chunks + 2,
          "LMC serving launched K1 {} and {} times; expected 2 per chunk "
          "(Kuu, Kzx)".format(bulk_k1, k1))
    check(mean.shape == (1, TRAIN_B, LMC_C)
          and cov.shape == (1, TRAIN_B, LMC_C, LMC_C)
          and cs_.shape == (1, 128, LMC_C, LMC_C) and np.isfinite(mean).all()
          and np.isfinite(cov).all(), "LMC served {} and {}".format(
              mean.shape, cov.shape))
    mu_g, var_g = q_moments_f64(linf.params, lm,
                                bulk[:F64_ROWS].astype(np.float64), False)
    Wmix = state_by_path(linf.params, linf.graphs)[
        "mixing_matrix"].double().cpu().numpy()
    lerr = max(rel_err(mean[0, :F64_ROWS], mu_g @ Wmix),
               rel_err(cov[0, :F64_ROWS],
                       var_g[:, None, None] * (Wmix.T @ Wmix)[None]))
    check(lerr <= NG_PRED_RTOL, "LMC served moments vs float64 on {} rows: "
          "rel {} > {}".format(F64_ROWS, lerr, NG_PRED_RTOL))
    print("phase 27 LMC ({}): B={}, M={}, D={}, Q={}, C={}, {} Adam steps "
          "(lr {}): K1 per step {} | losses {} | first loss float32 {:.8g} "
          "vs float64 {:.8g}: rel {:.3e} (tol {:.0e}) | step wall ms {} | "
          "served {} rows with the full {}x{} output covariance in {} "
          "chunks: {:.1f} rows/s, K1 {} | 128-row request {:.3f} ms | vs "
          "float64 on {} rows rel {:.3e} (tol {:.0e})".format(
              card, TRAIN_B, M, D, LMC_Q, LMC_C, len(lloop.losses), NG_LR,
              lloop.counts[0]["K1"],
              [round(float(v), 2) for v in lloop.losses],
              float(lloop.losses[0]), l64, lrel, NG_F64_RTOL,
              wall_summary(lloop.wall_s), TRAIN_B, LMC_C, LMC_C, chunks,
              TRAIN_B / bulk_s, bulk_k1, small_ms, F64_ROWS, lerr,
              NG_PRED_RTOL), flush=True)
    del mean, cov, linf, lloop, pred

    # ---- 28-29. deep GPs, two layers, regression and classification
    rng = np.random.default_rng(seed + 42)
    Z0s = [rng.uniform(0.0, BOX, (M, D)), rng.uniform(0.0, BOX, (M, DGP_H))]
    for phase, module, Yd in ((28, DeepGPRegression, Y),
                              (29, DeepGPClassification, labels)):
        label = "deep GP {}".format("regression" if phase == 28
                                    else "classification")
        dm, dalg = deep_gp_model(module, Z0s)
        zero_counts()
        dinf, dloop, dstart = train_nongaussian(loop_cls, dm, dalg, X, Yd,
                                                1, dev, seed + phase)
        add_launches()
        losses = check_steps(label, dloop, {"K1": 4})
        d32, d64, drel = fixed_draw_loss(module, Z0s, dstart, dalg,
                                         dloop.first_batch, dev)
        check(drel <= NG_F64_RTOL, "{}: first loss on fixed draws float32 "
              "{} vs float64 {}: rel {}".format(label, d32, d64, drel))
        pred = BatchedPredictor(model=dm, infr_params=dinf.params,
                                observed=[dm.X], target_variables=[dm.Y.uuid],
                                chunk_size=CHUNK)
        pred.predict(X=bulk[:CHUNK])
        (mean, var), bulk_s, bulk_k1, _, small_ms, k1 = serve_timed(
            pred, bulk, small, sync, read_counts, zero_counts)
        add_launches()
        check(bulk_k1 == 4 * chunks and k1 == 4 * chunks + 4,
              "{} serving launched K1 {} and {} times; expected 4 per chunk"
              .format(label, bulk_k1, k1))
        check(mean.shape == var.shape == (1, TRAIN_B, 1)
              and np.isfinite(mean).all() and np.isfinite(var).all()
              and var.min() >= -VAR_ATOL,
              "{}: served moments {} not finite or variance {} < -{}"
              .format(label, mean.shape, var.min(), VAR_ATOL))
        note = ("B={}, M={} a layer, D={} -> {} -> 1, S={}, whitened, {} "
                "Adam steps (lr {}): K1 per step {} | losses {} | first "
                "loss on fixed draws float32 {:.8g} vs float64 {:.8g}: rel "
                "{:.3e} (tol {:.0e}) | step wall ms {}".format(
                    TRAIN_B, M, D, DGP_H, DGP_S, len(losses), NG_LR,
                    dloop.counts[0]["K1"], [round(v, 2) for v in losses],
                    d32, d64, drel, NG_F64_RTOL, wall_summary(dloop.wall_s)))
        if phase == 28:
            prof = profile_steps(
                lambda loop: GradBasedInference(dalg, grad_loop=loop,
                                                dtype="float32", device=dev),
                {"X": X[:TRAIN_B], "Y": Yd[:TRAIN_B]}, PROFILE_STEPS, NG_LR,
                ROOT / "build" / "chip_smoke_deep_gp_trace.json")
            m32, m64 = fixed_draw_moments(module, Z0s, dinf.params,
                                          dinf.graphs, bulk[:F64_ROWS], dev)
            merr = max(rel_err(a, b) for a, b in zip(m32, m64))
            check(merr <= NG_PRED_RTOL, "{}: served moments on fixed draws "
                  "float32 vs float64 on {} rows: rel {}".format(
                      label, F64_ROWS, merr))
            note += (" | profile: {} | served {} rows ({} draws) in {} "
                     "chunks: {:.1f} rows/s, K1 {} | 128-row request {:.3f} "
                     "ms | moments on fixed draws float32 vs float64 on {} "
                     "rows: rel {:.3e} (tol {:.0e})".format(
                         profile_summary(prof, PROFILE_STEPS), TRAIN_B,
                         DGP_SERVE_S, chunks, TRAIN_B / bulk_s, bulk_k1,
                         small_ms, F64_ROWS, merr, NG_PRED_RTOL))
        else:
            check(mean.min() > 0.0 and mean.max() < 1.0, "{}: served "
                  "probabilities in [{}, {}]".format(label, mean.min(),
                                                     mean.max()))
            note += (" | served {} rows: {:.1f} rows/s, K1 {}, p in "
                     "[{:.4f}, {:.4f}] | 128-row request {:.3f} ms".format(
                         TRAIN_B, TRAIN_B / bulk_s, bulk_k1, mean.min(),
                         mean.max(), small_ms))
        print("phase {} {} ({}): {}".format(phase, label, card, note),
              flush=True)
        if phase == 28:
            deep_gp_pred = pred   # phase 55 exports it
            # phase 58 serves the same state with a Student-t propagation
            deep_gp_state = (Z0s, state_by_path(dinf.params, dinf.graphs))
        del dinf, dloop, pred, mean, var

    # ---- 30. natural gradients, minibatch: svgp_1m.py's ngd mode, one
    # epoch of NGD and one of Adam from one start and one permutation
    rng = np.random.default_rng(seed + 44)
    Xn = (rng.random((NGD_N, NGD_D)) * 4).astype(np.float32)
    fn = np.sin(Xn[:, :1] * 2.0) + 0.3 * np.cos(Xn[:, 1:2] * 3.0)
    Yn = (fn + rng.standard_normal((NGD_N, 1)) * 0.1).astype(np.float32)
    nm, nalg = gp_model(SVGPRegression, RBF(input_dim=NGD_D), NGD_D,
                        noise=0.5, inducing_inputs=Variable(
                            shape=(NGD_M, NGD_D),
                            initial_value=rng.random((NGD_M, NGD_D)) * 4))
    start_inf = GradBasedInference(nalg, dtype="float32", device=dev)
    start_inf.initialize(X=Xn[:NGD_B], Y=Yn[:NGD_B],
                         generator=torch.Generator(dev).manual_seed(seed))
    nstart = {k: v.clone() for k, v in start_inf.params.param_dict.items()}
    nloops = {}
    for which, cls, kw in (
            ("NGD", NaturalGradientMinibatchLoop,
             dict(module=nm.Y.factor, nat_learning_rate=NGD_GAMMA)),
            ("Adam", DeviceMinibatchLoop, {})):
        loop = recording_loop(cls, read_counts)(
            batch_size=NGD_B, rv_scaling={nm.Y: NGD_N / NGD_B}, **kw)
        inf = GradBasedInference(nalg, grad_loop=loop, dtype="float32",
                                 device=dev)
        inf.params.update_params({k: v.clone() for k, v in nstart.items()})
        zero_counts()
        inf.run(X=Xn, Y=Yn, max_iter=1, learning_rate=NGD_LR)
        add_launches()
        check_steps("{} epoch".format(which), loop,
                    {"K1": 1, "K2": 1, "K3": 3})
        nloops[which] = loop
    steps = -(-NGD_N // NGD_B)
    epoch = {k: float(np.mean([float(v) for v in loop.losses]))
             for k, loop in nloops.items()}
    trips = nloops["NGD"].guard_trips
    check(len(nloops["NGD"].losses) == len(nloops["Adam"].losses) == steps
          and epoch["NGD"] < epoch["Adam"], "NGD epoch: {} steps, mean loss "
          "{} against Adam's {} ({} steps)".format(
              len(nloops["NGD"].losses), epoch["NGD"], epoch["Adam"],
              len(nloops["Adam"].losses)))
    print("phase 30 natural gradients, minibatch ({}): N={}, d={}, B={}, "
          "M={}, gamma {}, Adam lr {}, one epoch of {} steps each from one "
          "start and permutation | launches per step {} | epoch mean loss "
          "NGD {:.8g} vs Adam {:.8g} | last loss NGD {:.8g} vs Adam {:.8g} | "
          "guard trips {} | step wall ms: NGD {} | Adam {}".format(
              card, NGD_N, NGD_D, NGD_B, NGD_M, NGD_GAMMA, NGD_LR, steps,
              nloops["NGD"].counts[0], epoch["NGD"], epoch["Adam"],
              float(nloops["NGD"].losses[-1]),
              float(nloops["Adam"].losses[-1]), trips,
              wall_summary(nloops["NGD"].wall_s, listed=False),
              wall_summary(nloops["Adam"].wall_s, listed=False)), flush=True)
    del Xn, Yn, fn, nloops

    # ---- 31. natural gradients, full batch: γ = 1 at phase 15's
    # configuration lands on the collapsed bound
    rng = np.random.default_rng(seed + 45)
    Xs, Ys = X[:SGP_N], Y[:SGP_N]
    Z0 = rng.uniform(0.0, BOX, (M, D))

    def model(module):
        return gp_model(module, RBF(input_dim=D, variance=1.0,
                                    lengthscale=math.sqrt(D)), D,
                        inducing_inputs=Variable(shape=(M, D),
                                                 initial_value=Z0),
                        jitter=0.0)

    _, salg = model(SparseGPRegression)
    bound64 = loss_and_grad_at(salg, None, [Xs, Ys], "float64", dev,
                               grad=False)[0]
    oracle = {}
    for dtype in ("float64", "float32"):
        om, oalg = model(SVGPRegression)
        loop = NaturalGradientLoop(om.Y.factor, nat_learning_rate=1.0)
        inf = GradBasedInference(oalg, grad_loop=loop, dtype=dtype,
                                 device=dev)
        inf.initialize(X=Xs, Y=Ys)
        kern = om.Y.factor._module_graph.kernel
        for v in (om.noise_var, kern.lengthscale, kern.variance,
                  om.Y.factor._module_graph.inducing_inputs):
            inf.params.fixed.add(v.uuid)
        losses = []
        zero_counts()
        t0 = time.perf_counter()
        inf.run(X=Xs, Y=Ys, max_iter=3, learning_rate=0.0,
                callback=lambda i, l: losses.append(l))
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        add_launches()
        oracle[dtype] = (losses, abs(losses[1] - bound64) / abs(bound64),
                         loop.guard_trips, counts, wall)
    losses64, rel64, trips64, _, _ = oracle["float64"]
    check(rel64 <= NGD_ORACLE_RTOL and trips64 == 0,
          "NGD at gamma 1, float64: step 2's loss {} vs the collapsed bound "
          "{}: rel {} > {} (guard trips {})".format(
              losses64[1], bound64, rel64, NGD_ORACLE_RTOL, trips64))
    losses32, rel32, trips32, counts32, wall32 = oracle["float32"]
    print("phase 31 natural gradients, full batch ({}): N={}, M={}, D={}, "
          "hyperparameters fixed, gamma 1, 3 steps | float64: losses {} vs "
          "the collapsed bound (SparseGPRegression, float64) {:.10g}: step "
          "2 rel {:.3e} (tol {:.0e}), guard trips {} | float32 (K1, K2, K3 "
          "on; launches {}): losses {}, step 2 rel {:.3e} to the float64 "
          "bound (information), guard trips {}, 3 steps in {:.3f} s | "
          "phases 27-31 took {:.1f} s".format(
              card, SGP_N, M, D, [float(v) for v in losses64], bound64,
              rel64, NGD_ORACLE_RTOL, trips64, counts32,
              [float(v) for v in losses32], rel32, trips32, wall32,
              time.perf_counter() - t_start), flush=True)
    return launches, deep_gp_pred, deep_gp_state


def headline_svgp(Z0):
    """Phase 6's model: SVGP regression at M = 512, D = 32, RBF with
    lengthscale sqrt(D) (at 1, every Kuf entry is about e^-42 and the
    kernels would be checked on zeros), a learned noise variance; fresh
    UUIDs at every call."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.modules import SVGPRegression
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0,
                          lengthscale=math.sqrt(D)),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=Variable(shape=(M, D), initial_value=Z0))
    return m


SERVE_ARTIFACT = r"""
import json, sys, time
import numpy as np
import torch
torch.set_float32_matmul_precision("medium")
sys.path.insert(0, {root!r})
from mxfusion_tpu_torch.inference import load_exported_predictor
from mxfusion_tpu_torch.ops import cuda_kernels

t0 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
cuda_init_s = time.perf_counter() - t0
t0 = time.perf_counter()
served = load_exported_predictor({artifact!r})
load_s = time.perf_counter() - t0
t0 = time.perf_counter()
load_exported_predictor({artifact!r})
load_again_s = time.perf_counter() - t0
X = np.load({request!r})
NAME = {name!r}
served.predict(**{{NAME: X[:{chunk}]}})
torch.cuda.synchronize()
cuda_kernels.rbf_kernel_matrix.launches = 0
t0 = time.perf_counter()
mu, var = served.predict(**{{NAME: X}})[0]
bulk_s = time.perf_counter() - t0
launches = cuda_kernels.rbf_kernel_matrix.launches
small_ms = []
for _ in range({reps}):
    t0 = time.perf_counter()
    served.predict(**{{NAME: X[:{small}]}})
    small_ms.append(1e3 * (time.perf_counter() - t0))
np.savez({out!r}, mu=mu, var=var)
from torch.profiler import profile, ProfilerActivity
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    served.predict(**{{NAME: X[:{chunk}]}})
    torch.cuda.synchronize()
k1 = sum(1 for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and "rbf_gram_kernel" in e.name)
held = [k for k in sys.modules if k.split(".")[0] in
        ("jax", "jaxlib", "mxfusion_tpu", "chip_smoke")
        and sys.modules[k] is not None]
print(json.dumps({{"cuda_init_s": cuda_init_s, "load_s": load_s,
                  "load_again_s": load_again_s,
                  "bulk_s": bulk_s, "launches": launches,
                  "small_ms": small_ms, "profile_k1": k1, "held": held,
                  "precision": torch.get_float32_matmul_precision()}}))
"""


def persistence_phases(dev, card, Xtr, Ytr, bulk, tm, start_state,
                       trained, pred, RecordingLoop, read_counts,
                       zero_counts, sync):
    """Phases 32-34 at phase 6's configuration; returns K1's launches by
    the main path here (the loaded predictor's and the artifact's)."""
    import torch
    from mxfusion_tpu_torch.inference import GradBasedInference, MAP
    from mxfusion_tpu_torch.ops import fused_gram
    from mxfusion_tpu_torch.util import CheckpointCallback, load_params
    from mxfusion_tpu_torch.inference import (BatchedPredictor,
                                              load_exported_predictor)
    t_phases = time.perf_counter()
    alg = MAP(model=tm, observed=[tm.X, tm.Y])
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    per_step = {"K1": 1, "K2": 1, "K3": fused_gram.BWD_LAUNCHES, "K4": 0,
                "K5": 0}

    # ---- 32. checkpoint/resume: two epochs of two fused steps on the
    # first 2·B rows (a snapshot every epoch is one every 2 steps), the
    # second resumed from the step-2 snapshot
    X2, Y2 = Xtr[:RESUME_ROWS], Ytr[:RESUME_ROWS]

    def run(epochs, callback=None, resume=None, path=None):
        loop = RecordingLoop(batch_size=TRAIN_B,
                             rv_scaling={tm.Y: RESUME_ROWS / TRAIN_B})
        inf = GradBasedInference(alg, grad_loop=loop, dtype="float32",
                                 device=dev)
        inf.params.update_params(
            {k: v.clone() for k, v in start_state.items()})
        state = None
        if resume is not None:
            state = load_params(inf.params, resume)
        inf.run(X=X2, Y=Y2, max_iter=epochs, learning_rate=3e-3,
                callback=callback(inf) if callback else None,
                resume_state=state)
        return loop, state

    ckpt = str(build / "chip_smoke_checkpoint.npz")
    whole, _ = run(2)
    first, _ = run(1, callback=lambda inf: CheckpointCallback(
        inf.params, ckpt, every=1))
    resumed, state = run(2, resume=ckpt)
    check(state.step == 1 and state.optimizer == "Adam",
          "snapshot at epoch {} of {}; expected epoch 1 (step 2) of Adam"
          .format(state.step, state.optimizer))
    for label, loop, n in (("uninterrupted", whole, 4), ("first", first, 2),
                           ("resumed", resumed, 2)):
        check(len(loop.counts) == n and all(c == per_step
                                            for c in loop.counts),
              "{} run: {} steps launching {}; expected {} steps of {}"
              .format(label, len(loop.counts), loop.counts, n, per_step))
    whole_losses = [float(x) for x in whole.losses]
    resumed_losses = [float(x) for x in resumed.losses]
    check(all(math.isfinite(x) for x in whole_losses + resumed_losses),
          "non-finite losses {} {}".format(whole_losses, resumed_losses))
    first_rel = max(abs(a - b) / abs(b) for a, b in zip(
        [float(x) for x in first.losses], whole_losses[:2]))
    resume_rel = max(abs(a - b) / abs(b) for a, b in zip(
        resumed_losses, whole_losses[2:]))
    check(resume_rel <= RESUME_RTOL, "resumed losses {} vs uninterrupted "
          "{}: max relative difference {} > {}".format(
              resumed_losses, whole_losses[2:], resume_rel, RESUME_RTOL))
    print("phase 32 checkpoint/resume ({}): {} rows, B={}, 2 epochs of 2 "
          "fused steps, a snapshot every epoch (every 2 steps) | launches "
          "per step {} in all 8 steps of the three runs | losses "
          "uninterrupted {} | steps 1-2 of the checkpointed run max rel "
          "{:.3e} | steps 3-4 resumed from the step-2 snapshot {}: max rel "
          "{:.3e} (tol {:.0e})".format(
              card, RESUME_ROWS, TRAIN_B, per_step, whole_losses, first_rel,
              resumed_losses, resume_rel, RESUME_RTOL), flush=True)

    # ---- 33. save, rebuild in code, load, serve 262144 rows
    zpath = str(build / "chip_smoke_inference.zip")
    sync()
    t0 = time.perf_counter()
    trained.save(zpath)
    save_s = time.perf_counter() - t0
    m2 = headline_svgp(np.zeros((M, D)))
    inf2 = GradBasedInference(MAP(model=m2, observed=[m2.X, m2.Y]),
                              dtype="float32", device=dev)
    inf2.initialize(X=Xtr[:TRAIN_B], Y=Ytr[:TRAIN_B])
    t0 = time.perf_counter()
    inf2.load(zpath)
    sync()
    load_s = time.perf_counter() - t0
    check(all(v.device == dev and v.dtype == torch.float32
              for v in inf2.params.param_dict.values())
          and len(inf2.params.param_dict) == len(trained.params.param_dict),
          "loaded store: {} entries, devices/dtypes {}".format(
              len(inf2.params.param_dict),
              {(str(v.device), str(v.dtype))
               for v in inf2.params.param_dict.values()}))
    zero_counts()
    live_out = pred.predict(X=bulk)[0]
    live_k1 = read_counts()["K1"]
    pred2 = BatchedPredictor(model=m2, infr_params=inf2.params,
                             observed=[m2.X], target_variables=[m2.Y.uuid],
                             chunk_size=CHUNK)
    zero_counts()
    mu2, var2 = pred2.predict(X=bulk)[0]
    load_k1 = read_counts()["K1"]
    chunks = -(-BULK_ROWS // CHUNK)
    # Kzx in every chunk and Kuu once: the new predictor keeps its factors
    check(load_k1 == chunks + 1, "the loaded predictor launched K1 {} "
          "times for {} chunks; expected 1 per chunk and 1 for Kuu".format(
              load_k1, chunks))

    def against_live(mu, var, label):
        check(mu.shape == var.shape == (1, BULK_ROWS, 1)
              and np.isfinite(mu).all() and np.isfinite(var).all(),
              "{}: shapes {} {} or non-finite".format(label, mu.shape,
                                                      var.shape))
        mean_rel = rel_err(mu, live_out[0])
        var_abs = float(np.max(np.abs(var - live_out[1])))
        check(mean_rel <= PLAIN_MEAN_RTOL and var_abs <= PLAIN_VAR_ATOL,
              "{} vs the live predictor: mean rel {} (tol {}), variance "
              "abs {} (tol {})".format(label, mean_rel, PLAIN_MEAN_RTOL,
                                       var_abs, PLAIN_VAR_ATOL))
        return mean_rel, var_abs

    load_err = against_live(mu2, var2, "loaded predictor")
    print("phase 33 save/load ({}): save {:.3f} s, rebuild + load {:.3f} s "
          "({} entries onto fresh UUIDs) | {} rows in {} chunks: K1 {} (1 "
          "per chunk and 1 for Kuu) | vs the live predictor: mean rel {:.3e} (tol {:.0e}), "
          "var abs {:.3e} (tol {:.0e})".format(
              card, save_s, load_s, len(inf2.params.param_dict), BULK_ROWS,
              chunks, load_k1, load_err[0], PLAIN_MEAN_RTOL, load_err[1],
              PLAIN_VAR_ATOL), flush=True)

    # ---- 34. export the live predictor; serve the artifact in a process
    # that builds no model and set the float32 matmul precision "medium"
    apath = build / "chip_smoke_predictor.zip"
    request = build / "chip_smoke_request.npy"
    served_out = build / "chip_smoke_served.npz"
    for f in (apath, served_out):
        if f.exists():
            f.unlink()
    np.save(request, bulk)
    t0 = time.perf_counter()
    pred.export(str(apath))
    export_s = time.perf_counter() - t0
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_ARTIFACT.format(
            root=str(ROOT), artifact=str(apath), request=str(request),
            out=str(served_out), chunk=CHUNK, small=SMALL_ROWS,
            reps=SMALL_REPS, name="X")],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "serving the artifact failed:\n{}{}"
          .format(proc.stdout[-4000:], proc.stderr[-4000:]))
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not child["held"], "the serving process imported {}".format(
        child["held"]))
    check(child["precision"] == "medium", "the serving process runs at "
          "{}".format(child["precision"]))
    check(child["profile_k1"] == 2, "the profile of one chunk shows "
          "rbf_gram_kernel {} times; expected 2 (Kuu, Kzx)".format(
              child["profile_k1"]))
    check(child["launches"] == 2 * chunks, "the artifact launched K1 {} "
          "times for {} chunks; expected 2 per chunk".format(
              child["launches"], chunks))
    with np.load(served_out) as served:
        export_err = against_live(served["mu"], served["var"],
                                  "exported artifact")
    # the artifact in this process too, alternated with the live
    # predictor, so that the two differ by the program alone
    here = load_exported_predictor(str(apath))
    targets = [n.target for n in here._program.graph.nodes
               if n.op == "call_function"]
    ops = torch.ops.mxfusion_tpu_torch
    plain = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
             torch.ops.aten.matmul.default, torch.ops.aten.einsum.default}
    n_tiered = targets.count(ops.tiered_einsum.default)
    check(targets.count(ops.rbf_gram.default) == 2 and n_tiered > 0
          and not plain & set(targets), "the exported program holds {} K1 "
          "nodes (expected 2), {} tiered products and plain products {}"
          .format(targets.count(ops.rbf_gram.default), n_tiered,
                  plain & set(targets)))
    here.predict(X=bulk[:CHUNK])
    timed = {"artifact": ([], []), "live": ([], [])}
    zero_counts()
    for which in ("live", "artifact", "artifact", "live"):
        server = here if which == "artifact" else pred
        sync()
        t0 = time.perf_counter()
        server.predict(X=bulk)
        timed[which][0].append(BULK_ROWS / (time.perf_counter() - t0))
        for _ in range(SMALL_REPS):
            t0 = time.perf_counter()
            server.predict(X=bulk[:SMALL_ROWS])
            timed[which][1].append(1e3 * (time.perf_counter() - t0))
    here_k1 = read_counts()["K1"]
    print("phase 34 export ({}): export {:.3f} s, artifact {} bytes | "
          "program: K1 2 nodes, {} tiered products, no plain product | "
          "served in a process that builds no model, imports no JAX, at "
          "float32 matmul precision {}: load_exported_predictor {:.3f} s "
          "(a second load in that process {:.3f} s) | "
          "{} rows: K1 {} (2 per chunk), a profiled chunk shows "
          "rbf_gram_kernel {} times | vs the live predictor: mean rel "
          "{:.3e}, var abs {:.3e} | there: {} rows/s {:.0f}, {}-row "
          "latency ms median of {} {:.3f} (its first CUDA call took {:.3f} "
          "s) | in this process, artifact and live predictor alternated: "
          "rows/s artifact {}, live {}; {}-row latency ms median artifact "
          "{:.3f}, live {:.3f} | phases 32-34 took {:.1f} s".format(
              card, export_s, apath.stat().st_size, n_tiered,
              child["precision"],
              child["load_s"], child["load_again_s"], BULK_ROWS,
              child["launches"],
              child["profile_k1"], export_err[0], export_err[1], BULK_ROWS,
              BULK_ROWS / child["bulk_s"], SMALL_ROWS, SMALL_REPS,
              float(np.median(child["small_ms"])), child["cuda_init_s"],
              [round(x) for x in timed["artifact"][0]],
              [round(x) for x in timed["live"][0]], SMALL_ROWS,
              float(np.median(timed["artifact"][1])),
              float(np.median(timed["live"][1])),
              time.perf_counter() - t_phases), flush=True)
    trained_counts = {k: sum(c[k] for loop in (whole, first, resumed)
                             for c in loop.counts) for k in per_step}
    return {"K1": trained_counts["K1"] + live_k1 + load_k1
            + child["launches"] + here_k1, "K2": trained_counts["K2"],
            "K3": trained_counts["K3"]}


def deep_kernel_model(Xz, seed, dev):
    """Phase 35's model: ``X_raw`` (n, D) → Linear(D, 64) → tanh →
    Linear(64, D) → ``SVGPRegression`` over the features (RBF, M = 512, a
    learned noise variance). The network's weights come from
    ``torch.manual_seed(seed)``; Z starts at the features of the M rows
    ``Xz`` and the lengthscale at half their median distance (Kuu's
    condition number about 1e3, phase 6's order)."""
    import torch
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.functions import NNFunction
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.modules import SVGPRegression
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(D, DK_HIDDEN),
                              torch.nn.Tanh(), torch.nn.Linear(DK_HIDDEN, D))
    with torch.no_grad():
        Z0 = net(torch.as_tensor(Xz)).double()
    dist = torch.cdist(Z0, Z0)
    lengthscale = float(dist[dist > 0].median()) / 2
    m = Model()
    m.n = Variable()
    m.X_raw = Variable(shape=(m.n, D))
    m.features = NNFunction(net, name="feat", input_shapes=[(TRAIN_B, D)],
                            device=dev)(m.X_raw)
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.1)
    m.Y = SVGPRegression.define_variable(
        X=m.features, kernel=RBF(input_dim=D, variance=1.0,
                                 lengthscale=lengthscale),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=Variable(shape=(M, D), initial_value=Z0.numpy()))
    return m


def deep_kernel_phases(dev, card, seed, Xtr, Ytr, phase6_wall, read_counts,
                       zero_counts, sync, RecordingLoop):
    """Phases 35-36: the deep-kernel SVGP trained on phase 6's data and
    configuration, where K3's dXs is the network's gradient, then served
    with the raw inputs observed. Returns the launches of the main path
    (training and serving)."""
    from mxfusion_tpu_torch.inference import (BatchedPredictor,
                                              GradBasedInference, MAP)
    from mxfusion_tpu_torch.ops import cuda_kernels, fused_gram
    from mxfusion_tpu_torch.util.carryover import (carryover_params,
                                                   name_paths)
    rng = np.random.default_rng(seed + 35)
    m = deep_kernel_model(Xtr[rng.choice(TRAIN_N, M, replace=False)],
                          seed + 35, dev)
    alg = MAP(model=m, observed=[m.X_raw, m.Y])
    start = GradBasedInference(alg, dtype="float32", device=dev)
    start.initialize(X_raw=Xtr[:TRAIN_B], Y=Ytr[:TRAIN_B])
    start_state = {k: v.clone() for k, v in start.params.param_dict.items()}
    scaling = {m.Y.uuid: TRAIN_N / TRAIN_B}

    def train(fused):
        loop = RecordingLoop(batch_size=TRAIN_B,
                             rv_scaling={m.Y: TRAIN_N / TRAIN_B})
        inf = GradBasedInference(alg, grad_loop=loop, dtype="float32",
                                 device=dev)
        inf.params.update_params(
            {k: v.clone() for k, v in start_state.items()})
        with contextlib.nullcontext() if fused else fused_gram.disabled():
            inf.run(X_raw=Xtr, Y=Ytr, max_iter=1, learning_rate=3e-3)
        return loop, inf

    # ---- 35. deep-kernel training: the main path is the fused epoch
    zero_counts()
    fused_loop, trained = train(True)
    sync()
    train_launches = read_counts()
    per_step = {"K1": 1, "K2": 1, "K3": fused_gram.BWD_LAUNCHES, "K4": 0,
                "K5": 0}
    for i, counts in enumerate(fused_loop.counts):
        check(counts == per_step, "deep-kernel step {} launched {}; "
              "expected {}".format(i, counts, per_step))
    check(len(fused_loop.counts) == TRAIN_STEPS, "deep kernel: {} steps, "
          "expected {}".format(len(fused_loop.counts), TRAIN_STEPS))
    plain_loop, _ = train(False)
    fused_losses = [float(x) for x in fused_loop.losses]
    plain_losses = [float(x) for x in plain_loop.losses]
    check(all(math.isfinite(x) for x in fused_losses + plain_losses),
          "deep kernel: non-finite loss: {} {}".format(fused_losses,
                                                       plain_losses))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fused_losses,
                                                       plain_losses))
    check(loss_rel <= TRAIN_LOSS_RTOL, "deep kernel: fused vs materialized "
          "losses part by {}: {} vs {}".format(loss_rel, fused_losses,
                                               plain_losses))
    batch = fused_loop.first_batch
    f64_loss = loss_and_grad_at(alg, start_state, batch, "float64", dev,
                                grad=False, rv_scaling=scaling)[0]
    f64_rel = abs(fused_losses[0] - f64_loss) / abs(f64_loss)
    check(f64_rel <= F64_LOSS_RTOL, "deep kernel: first loss {} vs float64 "
          "{}: relative {}".format(fused_losses[0], f64_loss, f64_rel))
    # the network's gradient at the start state and the first batch: K3's
    # dXs (fused) against autograd through the materialized Kuf
    before = read_counts()
    _, g_fused = loss_and_grad_at(alg, start_state, batch, "float32", dev,
                                  rv_scaling=scaling)
    k3 = read_counts()["K3"] - before["K3"]
    check(k3 == fused_gram.BWD_LAUNCHES, "the fused gradient launched K3 "
          "{} times".format(k3))
    with fused_gram.disabled():
        _, g_plain = loss_and_grad_at(alg, start_state, batch, "float32",
                                      dev, rv_scaling=scaling)
    paths = name_paths([m])
    net_grads = {paths[k]: rel_err(g_fused[k], g_plain[k])
                 for k in g_plain if paths[k].startswith("features.")}
    check(len(net_grads) == 4, "network gradients: {}".format(
        sorted(net_grads)))
    grad_err = max(net_grads.values())
    check(grad_err <= DK_GRAD_RTOL, "deep kernel: network gradients, fused "
          "vs materialized, part by {} of their largest entry (tol {}): "
          "{}".format(grad_err, DK_GRAD_RTOL, net_grads))
    wall_s = []
    for _round in range(STEP_WALL_ROUNDS):
        for _epoch in range(2):
            wall_s += train(True)[0].wall_s
    q1, med, q3 = np.percentile(1e3 * np.asarray(wall_s), [25, 50, 75])
    prof = profile_steps(
        lambda loop: GradBasedInference(alg, grad_loop=loop,
                                        dtype="float32", device=dev),
        {"X_raw": Xtr[:TRAIN_B], "Y": Ytr[:TRAIN_B]}, PROFILE_STEPS, 3e-3,
        ROOT / "build" / "chip_smoke_deep_kernel_trace.json")
    print("phase 35 deep-kernel training ({}): {} rows, B={}, M={}, "
          "Linear({}, {}) -> tanh -> Linear({}, {}) -> RBF SVGP, {} Adam "
          "steps | per step launches {} | losses fused {} materialized {} "
          "(max rel {:.3e}, tol {:.0e}) | first loss vs float64 {:.6f}: rel "
          "{:.3e} (tol {:.0e}) | network gradients fused vs materialized, "
          "of each one's largest entry: {} (max {:.3e}, tol {:.0e}) | step "
          "wall ms: median {:.3f} (quartiles {:.3f}-{:.3f}) of {}, beside "
          "phase 6's fused {} | profile of {} steps on B rows: {}".format(
              card, TRAIN_N, TRAIN_B, M, D, DK_HIDDEN, DK_HIDDEN, D,
              TRAIN_STEPS, fused_loop.counts[0], fused_losses, plain_losses,
              loss_rel, TRAIN_LOSS_RTOL, f64_loss, f64_rel, F64_LOSS_RTOL,
              {k: "{:.3e}".format(v) for k, v in sorted(net_grads.items())},
              grad_err, DK_GRAD_RTOL, med, q1, q3, len(wall_s),
              phase6_wall, PROFILE_STEPS,
              profile_summary(prof, PROFILE_STEPS)), flush=True)

    # ---- 36. deep-kernel serving: 262144 rows with X_raw observed
    def predictor(params):
        return BatchedPredictor(model=m, infr_params=params,
                                observed=[m.X_raw],
                                target_variables=[m.Y.uuid],
                                chunk_size=CHUNK)

    pred = predictor(trained.params)
    pred.predict(X_raw=Xtr[:CHUNK])
    sync()
    zero_counts()
    t0 = time.perf_counter()
    mu, var = pred.predict(X_raw=Xtr)[0]
    bulk_s = time.perf_counter() - t0
    serve_launches = read_counts()
    chunks = -(-TRAIN_N // CHUNK)
    # Kzx alone: the warm predictor keeps the factors of Kuu it built
    check(serve_launches["K1"] == chunks, "deep-kernel serving launched "
          "K1 {} times for {} chunks; expected 1 a chunk (Kzx)".format(
              serve_launches["K1"], chunks))
    check(mu.shape == var.shape == (1, TRAIN_N, 1) and np.isfinite(mu).all()
          and np.isfinite(var).all() and var.min() >= -VAR_ATOL,
          "deep-kernel serving: shapes {} {}, min variance {}".format(
              mu.shape, var.shape, var.min()))
    small_ms = []
    for _ in range(SMALL_REPS):
        t0 = time.perf_counter()
        pred.predict(X_raw=Xtr[:SMALL_ROWS])
        small_ms.append(1e3 * (time.perf_counter() - t0))
    cuda_kernels.set_use_kernel(False)
    try:
        mu_p, var_p = predictor(trained.params).predict(X_raw=Xtr)[0]
    finally:
        cuda_kernels.set_use_kernel(True)
    mean_err = rel_err(mu, mu_p)
    var_err = float(np.max(np.abs(var - var_p)))
    check(mean_err <= PLAIN_MEAN_RTOL and var_err <= PLAIN_VAR_ATOL,
          "deep-kernel serving, kernel vs plain: mean rel {}, variance abs "
          "{}".format(mean_err, var_err))
    state = {k: v.double().cpu().numpy() for k, v in
             state_by_path(trained.params, trained.graphs).items()}
    params64 = carryover_params(state, [m], dtype="float64", device=dev)
    mu64, var64 = predictor(params64).predict(
        X_raw=Xtr[:F64_ROWS].astype(np.float64))[0]
    f64_mean = rel_err(mu[:, :F64_ROWS], mu64)
    f64_var = rel_err(var[:, :F64_ROWS], var64)
    check(f64_mean <= F64_RTOL and f64_var <= F64_RTOL, "deep-kernel "
          "serving vs float64: mean rel {}, variance rel {} (tol {})".format(
              f64_mean, f64_var, F64_RTOL))
    print("phase 36 deep-kernel serving ({}): {} rows in chunks of {} | K1 "
          "launches {} (1 a chunk) | vs plain: mean rel {:.3e}, var abs "
          "{:.3e} | vs float64 on {} rows: mean rel {:.3e}, var rel {:.3e} "
          "(tol {:.0e}) | {:.0f} rows/s ({:.3f} s) | {}-row latency ms: "
          "median {:.3f} of {}".format(
              card, TRAIN_N, CHUNK, serve_launches["K1"], mean_err, var_err,
              F64_ROWS, f64_mean, f64_var, F64_RTOL, TRAIN_N / bulk_s,
              bulk_s, SMALL_ROWS, float(np.median(small_ms)), SMALL_REPS),
          flush=True)
    counts = {k: train_launches[k] + serve_launches[k]
              for k in train_launches}
    return counts, pred


def artifact_phases(dev, card, Xtr, dk_pred, dgp_pred, read_counts,
                    zero_counts, sync):
    """Phases 54-55: phase 36's deep-kernel predictor exported and served
    in a process that builds no model, and phase 28's deep GP predictor,
    whose prediction draws, exported and served on two seeds. Returns
    K1's launches by the artifacts here and there."""
    import torch
    from mxfusion_tpu_torch.inference import load_exported_predictor
    t_phases = time.perf_counter()
    build = ROOT / "build"
    chunks = -(-TRAIN_N // CHUNK)

    def against(out, ref, label, exact=False):
        (mu, var), (mu_r, var_r) = out, ref
        check(mu.shape == var.shape == mu_r.shape and np.isfinite(mu).all()
              and np.isfinite(var).all(), "{}: shapes {} {} or non-finite"
              .format(label, mu.shape, var.shape))
        mean_rel, var_abs = rel_err(mu, mu_r), float(np.max(np.abs(
            var - var_r)))
        check(mean_rel <= PLAIN_MEAN_RTOL and var_abs <= PLAIN_VAR_ATOL,
              "{} vs the live predictor: mean rel {} (tol {}), variance abs "
              "{} (tol {})".format(label, mean_rel, PLAIN_MEAN_RTOL, var_abs,
                                   PLAIN_VAR_ATOL))
        return mean_rel, var_abs, bool(np.array_equal(mu, mu_r)
                                       and np.array_equal(var, var_r))

    def live_timed(pred, name):
        sync()
        t0 = time.perf_counter()
        out = pred.predict(**{name: Xtr})[0]
        bulk_s = time.perf_counter() - t0
        small_ms = []
        for _ in range(SMALL_REPS):
            t0 = time.perf_counter()
            pred.predict(**{name: Xtr[:SMALL_ROWS]})
            small_ms.append(1e3 * (time.perf_counter() - t0))
        return out, bulk_s, float(np.median(small_ms))

    # ---- 54. the network artifact: Linear -> tanh -> Linear -> SVGP
    apath = build / "chip_smoke_deep_kernel.zip"
    request = build / "chip_smoke_deep_kernel_request.npy"
    served_out = build / "chip_smoke_deep_kernel_served.npz"
    for f in (apath, served_out):
        if f.exists():
            f.unlink()
    np.save(request, Xtr)
    t0 = time.perf_counter()
    dk_pred.export(str(apath))
    export_s = time.perf_counter() - t0
    meta = artifact_meta(apath)
    check(meta["draws"] == [] and meta["matmul_precision"] == "highest",
          "the network artifact records draws {} and precision {}".format(
              meta["draws"], meta["matmul_precision"]))
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_ARTIFACT.format(
            root=str(ROOT), artifact=str(apath), request=str(request),
            out=str(served_out), chunk=CHUNK, small=SMALL_ROWS,
            reps=SMALL_REPS, name="X_raw")],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "serving the network artifact failed:\n"
          "{}{}".format(proc.stdout[-4000:], proc.stderr[-4000:]))
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not child["held"], "the serving process imported {}".format(
        child["held"]))
    check(child["precision"] == "medium", "the serving process runs at "
          "{}".format(child["precision"]))
    check(child["profile_k1"] == 2, "the profile of one network-artifact "
          "chunk shows rbf_gram_kernel {} times; expected 2 (Kuu, Kzx)"
          .format(child["profile_k1"]))
    check(child["launches"] == 2 * chunks, "the network artifact launched "
          "K1 {} times for {} chunks; expected 2 a chunk".format(
              child["launches"], chunks))
    zero_counts()
    live, live_s, live_small = live_timed(dk_pred, "X_raw")
    live_k1 = read_counts()["K1"]
    with np.load(served_out) as served:
        dk_err = against((served["mu"], served["var"]), live,
                         "network artifact (served at \"medium\")")
    print("phase 54 network artifact ({}): Linear({}, {}) -> tanh -> "
          "Linear({}, {}) -> SVGP (M={}), export at chunk {} {:.3f} s, {} "
          "bytes, {} buffers, no draw | served in a process that builds no "
          "model and imports no network class, at float32 matmul precision "
          "{}: load {:.3f} s | {} rows: K1 {} (2 a chunk), a profiled chunk "
          "shows rbf_gram_kernel {} times | vs the live predictor (IEEE "
          "pinned around both): mean rel {:.3e} (tol {:.0e}), var abs "
          "{:.3e} (tol {:.0e}), bit-equal {} | rows/s artifact {:.0f}, live "
          "{:.0f}; {}-row latency ms median of {}: artifact {:.3f}, live "
          "{:.3f}".format(
              card, D, DK_HIDDEN, DK_HIDDEN, D, M, CHUNK, export_s,
              apath.stat().st_size, len(meta["buffers"]),
              child["precision"], child["load_s"], TRAIN_N,
              child["launches"], child["profile_k1"], dk_err[0],
              PLAIN_MEAN_RTOL, dk_err[1], PLAIN_VAR_ATOL, dk_err[2],
              TRAIN_N / child["bulk_s"], TRAIN_N / live_s, SMALL_ROWS,
              SMALL_REPS, float(np.median(child["small_ms"])), live_small),
          flush=True)

    # ---- 55. the drawing artifact: the deep GP's propagation draws as
    # program inputs, drawn from the caller's generator at each chunk
    gpath = build / "chip_smoke_deep_gp.zip"
    t0 = time.perf_counter()
    dgp_pred.export(str(gpath))
    gexport_s = time.perf_counter() - t0
    served = load_exported_predictor(str(gpath))
    draws = [(d["kind"], tuple(d["shape"]))
             for d in artifact_meta(gpath)["draws"]]
    check(len(draws) == 1 and draws[0][0] == "normal", "the deep GP "
          "artifact records draws {}".format(draws))
    served.predict(X=Xtr[:CHUNK])
    outs, errs, walls, k1 = {}, [], {"live": [], "artifact": []}, []
    for seed in (1, 2):
        for which, server in (("live", dgp_pred), ("artifact", served)):
            g = torch.Generator(dev).manual_seed(seed)
            sync()
            zero_counts()
            t0 = time.perf_counter()
            outs[which, seed] = server.predict(X=Xtr, generator=g)[0]
            walls[which].append(time.perf_counter() - t0)
            if which == "artifact":
                k1.append(read_counts()["K1"])
        errs.append(against(outs["artifact", seed], outs["live", seed],
                            "deep GP artifact, seed {}".format(seed)))
    check(k1 == [4 * chunks, 4 * chunks], "the deep GP artifact launched "
          "K1 {} times for {} chunks; expected 4 a chunk".format(k1, chunks))
    seed_gap = rel_err(outs["artifact", 1][0], outs["artifact", 2][0])
    check(seed_gap > 0, "the two seeds' served means are equal: a draw is "
          "baked into the program")
    zero_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        served.predict(X=Xtr[:CHUNK])
        sync()
    k1.append(read_counts()["K1"])
    profile_k1 = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "rbf_gram_kernel" in e.name)
    # the wrapper's count decides; the profiler's is information (in a
    # process that has profiled many windows before it can miss events)
    check(k1[2] == 4, "a profiled deep GP artifact chunk launched K1 {} "
          "times; expected 4".format(k1[2]))
    print("phase 55 drawing artifact ({}): deep GP regression (phase 28: "
          "RBF({}) -> {} -> RBF({}) -> 1, M={} a layer, S={}), export {:.3f} "
          "s, {} bytes, base draws {} | {} rows on "
          "torch.Generator(\"cuda\").manual_seed(s), s = 1, 2: vs the live "
          "predictor mean rel {}, var abs {}, bit-equal {} | the seeds' "
          "means part by {:.3e} | K1 {} (4 a chunk), a profiled chunk: K1 "
          "{}, the profiler saw rbf_gram_kernel {} times | rows/s artifact "
          "{}, live {} | phases 54-55 took {:.1f} s".format(
              card, D, DGP_H, DGP_H, M, DGP_S, gexport_s,
              gpath.stat().st_size, draws, TRAIN_N,
              ["{:.3e}".format(e[0]) for e in errs],
              ["{:.3e}".format(e[1]) for e in errs], [e[2] for e in errs],
              seed_gap, k1[:2], k1[2], profile_k1,
              [round(TRAIN_N / w) for w in walls["artifact"]],
              [round(TRAIN_N / w) for w in walls["live"]],
              time.perf_counter() - t_phases), flush=True)
    return child["launches"] + live_k1 + sum(k1), [
        TRAIN_N / w for w in walls["artifact"]]


def artifact_meta(path):
    """An exported predictor's ``meta.json``."""
    import zipfile
    with zipfile.ZipFile(path) as zf:
        return json.loads(zf.read("meta.json"))


# phase 56 also runs the examples at full size, in the order of their
# walls at smoke size (each script's own full-size assertions run inside
# its main()), while the phase has taken less than EXAMPLES_FULL_START_S
EXAMPLES_FULL_START_S = 110.0


def example_phases(card, read_counts, zero_counts, sync):
    """Phase 56: every ``examples/torch/`` script's ``main()`` in this
    process on the card, at ``MXF_SMOKE`` size (the raised counts of
    ``SIZES`` where a test names them) held to the band of its CPU test
    (``tests/test_torch_examples_a.py``), then at full size while the
    phase's time allows. Returns the launches of K1-K5, R1 and R2."""
    # by its path: a machine may have another package named "tests"
    spec = importlib.util.spec_from_file_location(
        "torch_examples_bands", ROOT / "tests" / "test_torch_examples_a.py")
    examples = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(examples)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "R1", "R2"), 0)

    def run(name, smoke):
        zero_counts()
        sync()
        t0 = time.perf_counter()
        value = examples.run_example(name, smoke=smoke)
        sync()
        wall = time.perf_counter() - t0
        counts = dict(read_counts(), **read_keyed())
        for k in totals:
            totals[k] += counts[k]
        return value, wall, counts

    smoke_walls = {}
    for name in sorted(examples.BANDS):
        value, wall, counts = run(name, True)
        smoke_walls[name] = wall
        try:
            examples.in_band(name, value)
            band = "in band {} of JAX's {}".format(
                examples.BANDS[name], examples.GOLDEN[name])
        except AssertionError as e:
            check(False, "phase 56: {} returned {}, outside the band {} of "
                  "JAX's {}: {}".format(name, value, examples.BANDS[name],
                                        examples.GOLDEN[name], e))
        print("phase 56 example ({}): {} at MXF_SMOKE size{} -> {} in "
              "{:.3f} s | K1 {} K2 {} K3 {} K4 {} | {}".format(
                  card, name, "".join(
                      ", {} {}".format(k, v)
                      for k, v in examples.SIZES.get(name, {}).items()),
                  examples.as_json(value), wall, counts["K1"],
                  counts["K2"], counts["K3"], counts["K4"], band),
              flush=True)
    smoke_s = time.perf_counter() - t_phase
    cut = []
    for name in sorted(smoke_walls, key=smoke_walls.get):
        if time.perf_counter() - t_phase > EXAMPLES_FULL_START_S:
            cut.append(name)
            continue
        value, wall, counts = run(name, False)
        got = examples.as_json(value)
        check(got is None or isinstance(got, str)
              or np.isfinite(np.asarray(got, dtype=float)).all(),
              "phase 56: {} at full size returned {}".format(name, got))
        print("phase 56 example ({}): {} at full size -> {} in {:.3f} s | "
              "K1 {} K2 {} K3 {} K4 {}".format(
                  card, name, got, wall, counts["K1"], counts["K2"],
                  counts["K3"], counts["K4"]), flush=True)
    print("phase 56 examples ({}): {} scripts at MXF_SMOKE size in {:.1f} s, "
          "every one in its band; {} at full size; cut to MXF_SMOKE size "
          "only: {} | launches K1 {} K2 {} K3 {} K4 {} K5 {} R1 {} R2 {} | "
          "phase 56 took {:.1f} s".format(
              card, len(examples.BANDS), smoke_s,
              len(smoke_walls) - len(cut), cut or "none", totals["K1"],
              totals["K2"], totals["K3"], totals["K4"], totals["K5"],
              totals["R1"], totals["R2"], time.perf_counter() - t_phase),
          flush=True)
    return totals


# the kernels each GP notebook's path must launch on the card: its RBF
# grams, and the SVGP minibatch's fused L⁻¹Kuf forward and backward
NOTEBOOK_KERNELS = {"gp_regression": ("K1",),
                    "svgp_regression": ("K1", "K2", "K3"),
                    "deep_gp": ("K1",)}


def notebook_phases(card, read_counts, zero_counts, sync):
    """Phase 57: the code cells of every ``examples/torch/notebooks/``
    notebook in one namespace each, in this process on the card at the
    notebook's own counts (nothing pins the CPU), every printed number
    finite and in the band of its CPU test
    (``tests/test_torch_notebooks_a.py``). Returns the launches of
    K1-K5, R1 and R2."""
    import torch
    # by its path: a machine may have another package named "tests"
    spec = importlib.util.spec_from_file_location(
        "torch_notebook_bands", ROOT / "tests" / "test_torch_notebooks_a.py")
    bands = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bands)
    t_phase = time.perf_counter()
    totals = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "R1", "R2"), 0)
    for name in bands.NOTEBOOKS:
        zero_counts()
        sync()
        t0 = time.perf_counter()
        torch.manual_seed(0)
        ns, outputs = bands.generate.run_cells(bands.load(name), name)
        sync()
        wall = time.perf_counter() - t0
        counts = dict(read_counts(), **read_keyed())
        for k in totals:
            totals[k] += counts[k]
        for k in NOTEBOOK_KERNELS.get(name, ()):
            check(counts[k] > 0, "phase 57: {} launched {} no time".format(
                name, k))
        text = "".join(outputs)
        probes = bands.probe_values(name, ns)
        try:
            # the JAX notebook's lines, every number finite and in band
            bands.hold_to_jax(name, text, probes)
        except AssertionError as e:
            check(False, "phase 57: {} printed {} outside its band around "
                  "JAX's {}: {}".format(name, text, "".join(
                      bands.GOLDEN[name]["outputs"]), e))
        shown = [line for line in text.splitlines()
                 if not line.startswith("Iteration ")]
        print("phase 57 notebook ({}): {} -> {}{} in {:.3f} s | K1 {} K2 {} "
              "K3 {} K4 {} K5 {} R1 {} R2 {} | every value in band".format(
                  card, name, " / ".join(shown),
                  " {}".format(probes) if probes else "", wall,
                  counts["K1"], counts["K2"], counts["K3"], counts["K4"],
                  counts["K5"], counts["R1"], counts["R2"]), flush=True)
    print("phase 57 notebooks ({}): {} notebooks at their own counts, every "
          "printed value in its band | launches K1 {} K2 {} K3 {} K4 {} K5 {} "
          "R1 {} R2 {} | phase 57 took {:.1f} s".format(
              card, len(bands.NOTEBOOKS), totals["K1"], totals["K2"],
              totals["K3"], totals["K4"], totals["K5"], totals["R1"],
              totals["R2"], time.perf_counter() - t_phase), flush=True)
    return totals


def bnn_model(dtype, dev, seed):
    """BASELINE config 5a (benchmarks/bnn_vae_dp.py:30-71): y = MLP(x),
    8 → 64 → 64 → 1 with tanh, Normal(0, 1) priors over the 4801
    weights, a learned noise variance; its mean-field posterior."""
    import torch
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import Normal
    from mxfusion_tpu_torch.components.functions import NNFunction
    from mxfusion_tpu_torch.components.functions.operators import \
        broadcast_to
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import create_Gaussian_meanfield
    torch.manual_seed(seed)
    net = torch.nn.Sequential(
        torch.nn.Linear(BNN_IN, BNN_H), torch.nn.Tanh(),
        torch.nn.Linear(BNN_H, BNN_H), torch.nn.Tanh(),
        torch.nn.Linear(BNN_H, 1))
    m = Model()
    m.x = Variable(shape=(BNN_N, BNN_IN))
    m.r = NNFunction(net, name="f", input_shapes=[(BNN_N, BNN_IN)],
                     dtype=dtype, device=dev)(m.x)
    for v in m.r.factor.function.parameters.values():
        v.set_prior(Normal(mean=broadcast_to(Variable(value=0.), v.shape),
                           variance=broadcast_to(Variable(value=1.),
                                                 v.shape), dtype=dtype))
    m.noise = Variable(transformation=PositiveTransformation(),
                       initial_value=0.01)
    m.y = Normal.define_variable(
        mean=m.r, variance=broadcast_to(m.noise, (BNN_N, 1)),
        shape=(BNN_N, 1), dtype=dtype)
    q = create_Gaussian_meanfield(model=m, observed=[m.x, m.y], dtype=dtype)
    return m, q, [m.x, m.y]


def vae_model(dtype, dev, seed):
    """BASELINE config 5b (benchmarks/bnn_vae_dp.py:74-123): a decoder
    4 → 64 → 16 in the model and an encoder 16 → 64 → (4, 4) in the
    posterior (mean, and a variance through exp)."""
    import torch
    from mxfusion_tpu_torch import Model, Posterior, Variable
    from mxfusion_tpu_torch.components.distributions import Normal
    from mxfusion_tpu_torch.components.functions import NNFunction
    from mxfusion_tpu_torch.components.functions.operators import \
        broadcast_to

    class Encoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.hidden = torch.nn.Linear(VAE_D, VAE_H)
            self.mean = torch.nn.Linear(VAE_H, VAE_K)
            self.log_var = torch.nn.Linear(VAE_H, VAE_K)

        def forward(self, x):
            h = torch.tanh(self.hidden(x))
            return self.mean(h), torch.exp(self.log_var(h)) + 1e-6

    torch.manual_seed(seed)
    decoder = torch.nn.Sequential(torch.nn.Linear(VAE_K, VAE_H),
                                  torch.nn.Tanh(),
                                  torch.nn.Linear(VAE_H, VAE_D))
    m = Model()
    m.z = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (VAE_N, VAE_K)),
        variance=broadcast_to(Variable(value=1.), (VAE_N, VAE_K)),
        shape=(VAE_N, VAE_K), dtype=dtype)
    m.x_mean = NNFunction(decoder, name="dec",
                          input_shapes=[(VAE_N, VAE_K)], dtype=dtype,
                          device=dev)(m.z)
    m.x = Normal.define_variable(
        mean=m.x_mean,
        variance=broadcast_to(Variable(value=0.01), (VAE_N, VAE_D)),
        shape=(VAE_N, VAE_D), dtype=dtype)
    q = Posterior(m)
    q_mean, q_var = NNFunction(Encoder(), name="enc",
                               input_shapes=[(VAE_N, VAE_D)], num_outputs=2,
                               dtype=dtype, device=dev)(q.x)
    q.z.set_prior(Normal(mean=q_mean, variance=q_var, dtype=dtype))
    return m, q, [m.x]


def nn_inference(build, S, dev, dtype="float32", grad_loop=None,
                 noise=None):
    """SVI over ``build``'s model and posterior, every posterior latent
    drawing ``noise`` when it is given."""
    from mxfusion_tpu_torch.components.distributions import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.inference import (
        GradBasedInference, StochasticVariationalInference)
    m, q, observed = build(dtype, dev)
    if noise is not None:
        for v in posterior_latents(q):
            v.factor._rand_gen = FixedRandomGenerator(noise)
    return GradBasedInference(
        StochasticVariationalInference(num_samples=S, model=m, posterior=q,
                                       observed=observed),
        grad_loop=grad_loop, dtype=dtype, device=dev)


def nn_model_phases(dev, card, seed, read_counts, zero_counts, sync):
    """Phases 37-38: BASELINE config 5 (a Bayesian NN and a VAE) at
    benchmarks/bnn_vae_dp.py's widths. No kernel of K1-K5 lies on these
    paths: each run must launch none."""
    import torch
    from mxfusion_tpu_torch.inference import \
        VariationalPosteriorForwardSampling
    none = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    rng = np.random.default_rng(seed + 37)
    X = (rng.random((BNN_N, BNN_IN)) * 2 - 1).astype(np.float32)
    Y = (np.sin(3 * X[:, :1]) + rng.standard_normal((BNN_N, 1)) * 0.05
         ).astype(np.float32)
    z_true = rng.standard_normal((VAE_N, VAE_K))
    x_vae = (np.tanh(z_true @ rng.standard_normal((VAE_K, VAE_D)))
             + rng.standard_normal((VAE_N, VAE_D)) * 0.05).astype(np.float32)
    configs = {
        37: ("BNN (config 5a): N={} {} -> {} -> {} -> 1 tanh, {} weights "
             "under Normal(0, 1)".format(BNN_N, BNN_IN, BNN_H, BNN_H,
                                         BNN_IN * BNN_H + BNN_H * BNN_H
                                         + 2 * BNN_H + BNN_H + 1),
             lambda dtype, dev: bnn_model(dtype, dev, seed + 37),
             {"x": X, "y": Y}, BNN_S, BNN_LR),
        38: ("VAE (config 5b): N={} D={} K={}, decoder {} -> {} -> {}, "
             "encoder {} -> {} -> ({}, {})".format(
                 VAE_N, VAE_D, VAE_K, VAE_K, VAE_H, VAE_D, VAE_D, VAE_H,
                 VAE_K, VAE_K),
             lambda dtype, dev: vae_model(dtype, dev, seed + 38),
             {"x": x_vae}, VAE_S, VAE_LR)}
    for phase, (label, build, data, S, lr) in configs.items():
        zero_counts()
        inf, loop, start = train_recorded(
            lambda loop: nn_inference(build, S, dev, grad_loop=loop),
            data, NN_STEPS, lr, dev, seed + phase, read_counts, sync)
        sync()
        launches = read_counts()
        check(launches == none, "{}: launched {}; this path has no kernel"
              .format(label, launches))
        losses = loop.losses
        check(len(losses) == NN_STEPS
              and all(math.isfinite(v) for v in losses)
              and losses[-1] < losses[0],
              "{}: losses do not fall: {}".format(label, losses))
        n_noise = S * max(int(np.prod(v.shape)) for v in posterior_latents(
            inf.inference_algorithm.posterior))
        noise = np.random.default_rng(seed + phase).standard_normal(n_noise)
        l32 = loss_at(nn_inference(build, S, dev, "float32", noise=noise),
                      start, data, dev)
        l64 = loss_at(nn_inference(build, S, dev, "float64", noise=noise),
                      start, data, dev)
        rel = abs(l32 - l64) / abs(l64)
        check(rel <= NN_F64_RTOL, "{}: first loss float32 {} vs float64 {}: "
              "relative {}".format(label, l32, l64, rel))
        prof = profile_steps(
            lambda loop: nn_inference(build, S, dev, grad_loop=loop), data,
            PROFILE_STEPS, lr,
            ROOT / "build" / "chip_smoke_nn_{}_trace.json".format(phase),
            generator=torch.Generator(dev).manual_seed(seed))
        extra = ""
        if phase == 37:
            # the predictive mean of the trained posterior (example
            # bnn_regression.py): more steps, then 100 forward draws
            zero_counts()
            t0 = time.perf_counter()
            generator = torch.Generator(dev).manual_seed(seed)
            for _run in range(BNN_FIT_RUNS):
                inf.run(max_iter=BNN_FIT_STEPS, learning_rate=lr,
                        generator=generator, **data)
            sync()
            fit_s = time.perf_counter() - t0
            m = inf.graphs[0]
            (draws,) = VariationalPosteriorForwardSampling(
                num_samples=BNN_FS, observed=[m.x], inherited_inference=inf,
                target_variables=[m.y]).run(
                    x=X, generator=torch.Generator(dev).manual_seed(seed))
            sync()
            check(read_counts() == none, "BNN fit and forward sampling "
                  "launched {}".format(read_counts()))
            pred = draws.mean(dim=0)[:, 0].double().cpu().numpy()
            fit_err = float(np.mean(np.abs(pred - np.sin(3 * X[:, 0]))))
            check(tuple(draws.shape) == (BNN_FS, BNN_N, 1)
                  and fit_err <= BNN_FIT_ATOL, "BNN: {} forward draws {}, "
                  "predictive mean off sin(3 x0) by {} on average (tol {})"
                  .format(BNN_FS, tuple(draws.shape), fit_err,
                          BNN_FIT_ATOL))
            extra = " | {} runs of {} more steps ({:.3f} s), loss {:.6g}; " \
                "{} forward draws: predictive mean off sin(3 x0) by {:.4f} " \
                "on average (tol {})".format(
                    BNN_FIT_RUNS, BNN_FIT_STEPS, fit_s, loop.losses[-1],
                    BNN_FS, fit_err, BNN_FIT_ATOL)
        print("phase {} {}, S={}, {} Adam steps (lr {}) | launches {} | "
              "losses {:.6g} -> {:.6g} | first loss on fixed draws float32 "
              "{:.8g} vs float64 {:.8g}: rel {:.3e} (tol {:.0e}) | step "
              "wall ms ({}): {} | profile of {} steps: {}{}".format(
                  phase, label, S, NN_STEPS, lr, launches, losses[0],
                  losses[NN_STEPS - 1], l32, l64, rel, NN_F64_RTOL, card,
                  wall_summary(loop.wall_s[:NN_STEPS]), PROFILE_STEPS,
                  profile_summary(prof, PROFILE_STEPS), extra), flush=True)


def blr_model(n, d, noise_var, symbolic=False, rand_gen=None):
    """benchmarks/mcmc_throughput.py:31-48's Bayesian linear regression
    in the port: w ~ N(0, I), y ~ N(Xw, noise_var·I); the data axis is a
    symbolic dim (minibatch SGLD binds it to the batch) or ``n``."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import Normal
    from mxfusion_tpu_torch.components.functions.operators import (
        broadcast_to, dot)
    m = Model()
    if symbolic:
        m.n = Variable()
        n = m.n
    m.X = Variable(shape=(n, d))
    m.w = Normal.define_variable(
        mean=broadcast_to(Variable(value=0.), (d, 1)),
        variance=broadcast_to(Variable(value=1.), (d, 1)), shape=(d, 1),
        rand_gen=rand_gen)
    m.f = dot(m.X, m.w)
    m.y = Normal.define_variable(
        mean=m.f, variance=broadcast_to(Variable(value=noise_var), (n, 1)),
        shape=(n, 1))
    return m


def blr_data(rng, n, d, correlated=False):
    """mcmc_throughput.py's ``_make_data`` (float32, noise sd 0.5); with
    ``correlated``, tests/inference/test_chees.py:52-55's design
    X·(I + 0.5·A)."""
    X = rng.standard_normal((n, d))
    if correlated:
        X = X @ (np.eye(d) + 0.5 * rng.standard_normal((d, d)))
    X = X.astype(np.float32)
    w_true = rng.standard_normal((d, 1)).astype(np.float32)
    y = (X @ w_true + 0.5 * rng.standard_normal((n, 1))).astype(np.float32)
    return X, y


def blr_posterior(X, y, noise_var):
    """The float64 closed form μ and Σ = (XᵀX/σ² + I)⁻¹, and the
    precision's largest eigenvalue."""
    X = X.astype(np.float64)
    H = X.T @ X / noise_var + np.eye(X.shape[1])
    Sigma = np.linalg.inv(H)
    return Sigma @ X.T @ y[:, 0].astype(np.float64) / noise_var, Sigma, \
        float(np.linalg.eigvalsh(H)[-1])


def counting(m):
    """Counts ``m``'s potential evaluations (its ``log_pdf_terms`` calls,
    each one batched potential-and-gradient over every chain) in
    ``m.evaluations``."""
    inner = m.log_pdf_terms

    def log_pdf_terms(*args, **kwargs):
        m.evaluations += 1
        return inner(*args, **kwargs)
    m.evaluations = 0
    m.log_pdf_terms = log_pdf_terms
    return m


def gp_noise_model():
    """tests/inference/test_mcmc_over_modules.py:21-33's model at phase
    14's width: the noise variance of ``GPRegression(RBF(EXACT_D))`` under
    a Gamma(2, 20) prior, its potential evaluations counted."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import Gamma
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.modules import GPRegression
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, EXACT_D))
    m.noise_var = Gamma.define_variable(alpha=2.0, beta=20.0, shape=(1,))
    m.Y = GPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=EXACT_D, variance=1.0, lengthscale=1.0),
        noise_var=m.noise_var, shape=(m.n, 1))
    return counting(m)


def mc_error(draws, mu):
    """The largest |mean − μ| over the coordinates of draws (S, C, ...)
    in units of the Monte-Carlo standard error sd/sqrt(ESS); and the
    smallest ESS."""
    from mxfusion_tpu_torch.inference import effective_sample_size
    x = draws.reshape(draws.shape[0], draws.shape[1], -1)
    ess = np.atleast_1d(effective_sample_size(x))
    se = x.reshape(-1, x.shape[-1]).std(axis=0) / np.sqrt(ess)
    return float(np.max(np.abs(x.mean(axis=(0, 1)) - mu) / se)), \
        float(np.min(ess))


def mcmc_runs(m_obs):
    """Phase 39's four runs: name -> (symbolic data dim, algorithm
    factory of (model, kept draws, warmup), inference class, standard errors
    allowed, whether the error is of the chains' average, kept draws,
    warmup). SGLD's chains share every minibatch, so their draws are not
    independent: its standard error is that of their average, one
    series, whose ESS the pooled estimator would overstate."""
    from mxfusion_tpu_torch.inference import (
        ChEESHMCAlgorithm, ChEESHMCInference, HMCAlgorithm, HMCInference,
        ParallelTemperingAlgorithm, ParallelTemperingInference,
        SGLDAlgorithm, SGLDInference)
    return {
        "SGLD": (True, lambda m, S, W: SGLDAlgorithm(
            model=m, observed=m_obs(m), num_samples=S, num_burnin=W,
            num_chains=MCMC_CHAINS, batch_size=SGLD_B, step_size=SGLD_STEP,
            step_decay_gamma=0.0), SGLDInference, SGLD_SE, True,
            SGLD_DRAWS, SGLD_BURNIN),
        "HMC": (False, lambda m, S, W: HMCAlgorithm(
            model=m, observed=m_obs(m), num_samples=S, num_warmup=W,
            num_chains=MCMC_CHAINS, num_leapfrog=MCMC_L,
            step_size=MCMC_EPS0), HMCInference, MCMC_SE, False, HMC_DRAWS,
            MCMC_WARMUP),
        "PT": (False, lambda m, S, W: ParallelTemperingAlgorithm(
            model=m, observed=m_obs(m), num_samples=S, num_warmup=W,
            num_chains=MCMC_CHAINS, num_temps=PT_TEMPS, num_leapfrog=MCMC_L,
            step_size=MCMC_EPS0), ParallelTemperingInference, MCMC_SE,
            False, PT_DRAWS, MCMC_WARMUP),
        "ChEES": (False, lambda m, S, W: ChEESHMCAlgorithm(
            model=m, observed=m_obs(m), num_samples=S, num_warmup=W,
            num_chains=MCMC_CHAINS), ChEESHMCInference, MCMC_SE, False,
            CHEES_DRAWS, MCMC_WARMUP)}


def sampler_phases(dev, card, seed, Xe, Ye, read_counts, zero_counts,
                   sync):
    """Phases 39-41: the MCMC samplers. Returns K1's launches on their
    main paths (phase 40's chain and particles)."""
    import torch
    from mxfusion_tpu_torch.components.distributions.random_gen import \
        FixedRandomGenerator
    from mxfusion_tpu_torch.inference import (
        ChEESHMCAlgorithm, ChEESHMCInference, HMCAlgorithm, HMCInference,
        RuntimeContext, SGLDAlgorithm, SGLDInference, SVGDAlgorithm,
        SVGDInference, create_sampling_executor)
    from mxfusion_tpu_torch.inference import hmc
    from mxfusion_tpu_torch.ops import cuda_kernels
    none = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}

    def gen(k, device=dev):
        return torch.Generator(device).manual_seed(seed + k)

    # ---- 39. benchmarks/mcmc_throughput.py's configuration
    t_phase = time.perf_counter()
    X, y = blr_data(np.random.default_rng(seed), MCMC_N, MCMC_D)
    mu, _, lam_max = blr_posterior(X, y, MCMC_S2)
    # the benchmark's SGLD step against the stability limit 2/λmax of
    # the Langevin drift: a few hundred steps show where it goes
    m = blr_model(MCMC_N, MCMC_D, MCMC_S2, symbolic=True)
    zero_counts()
    bench = SGLDInference(SGLDAlgorithm(
        model=m, observed=[m.X, m.y], num_samples=SGLD_DIVERGE_STEPS,
        num_burnin=0, num_chains=MCMC_CHAINS, batch_size=SGLD_B,
        step_size=SGLD_BENCH_STEP, step_decay_gamma=0.0), dtype="float32",
        device=dev).run(X=X, y=y, generator=gen(38))[m.w.uuid]
    bench_max = float(torch.nan_to_num(bench[-1].abs(), nan=float("inf"))
                      .max())
    check(read_counts() == none, "phase 39: the benchmark's SGLD step "
          "launched {}".format(read_counts()))
    lines, chees_L = [], None
    for name, (symbolic, make, Infr, n_se, average, S, W) in mcmc_runs(
            lambda m: [m.X, m.y]).items():
        walls = []
        for k in range(2):           # the second run is the timed one
            m = counting(blr_model(MCMC_N, MCMC_D, MCMC_S2, symbolic))
            infr = Infr(make(m, S, W), dtype="float32", device=dev)
            zero_counts()
            sync()
            t0 = time.perf_counter()
            draws = infr.run(X=X, y=y, generator=gen(39 + k))[m.w.uuid]
            sync()
            walls.append(time.perf_counter() - t0)
            check(read_counts() == none, "phase 39 {}: launched {}; this "
                  "path has no kernel".format(name, read_counts()))
        d = infr.diagnostics
        draws = draws.double().cpu().numpy()
        check(draws.shape == (S, MCMC_CHAINS, MCMC_D, 1)
              and np.isfinite(draws).all(), "phase 39 {}: draws {} are "
              "not finite".format(name, draws.shape))
        err, ess = mc_error(draws.mean(axis=1, keepdims=True) if average
                            else draws, mu)
        check(err <= n_se, "phase 39 {}: the mean of w lies {:.2f} "
              "Monte-Carlo standard errors off the closed form (tol {})"
              .format(name, err, n_se))
        evals = m.evaluations
        # the model runs once per leapfrog step (HMC, PT) and once per
        # Langevin step, the carried potential once at the start
        expected = {"HMC": 1 + MCMC_L * (W + S), "PT": 1 + MCMC_L * (W + S),
                    "SGLD": W + S + 1}.get(name, evals)
        check(evals == expected, "phase 39 {}: {} potential evaluations, "
              "expected {}".format(name, evals, expected))
        extra = ""
        if "accept_rate" in d:
            extra += ", accept rate {:.3f}, adapted eps {:.4e}".format(
                float(np.mean(d["accept_rate"])), float(d["step_size"]))
        if name == "ChEES":
            chees_L = float(d["mean_leapfrog_steps"])
            extra += ", T {:.4e}, mean leapfrog steps {:.3f}".format(
                float(d["trajectory_length"]), chees_L)
        if name == "PT":
            extra += ", swap acceptance by pair {}".format(
                [round(float(v), 3) for v in d["swap_accept_rate"]])
        # the idle share of a window of 20 transitions (no warmup)
        mp = blr_model(MCMC_N, MCMC_D, MCMC_S2, symbolic)
        short = Infr(make(mp, PROFILE_TRANSITIONS, 0), dtype="float32",
                     device=dev)
        prof = profile_window(
            lambda: short.run(X=X, y=y, generator=gen(41)),
            ROOT / "build" / "chip_smoke_mcmc_{}_trace.json".format(name))
        lines.append(
            "{}: {:.1f} kept draws/s, {:.1f} potential-and-gradient "
            "evaluations/s ({} evaluations over {} chains and {} kept draws "
            "in {:.3f} s; first run {:.3f} s){}, max R-hat {:.4f}, mean of "
            "w {:.2f} standard errors off (min ESS {:.1f}; tol {}) | "
            "profile of {} transitions: {}".format(
                name, S / walls[1], evals / walls[1], evals, MCMC_CHAINS, S,
                walls[1], walls[0], extra, d["r_hat_max"], err, ess, n_se,
                PROFILE_TRANSITIONS,
                profile_summary(prof, PROFILE_TRANSITIONS)))
    print("phase 39 mcmc ({}): benchmarks/mcmc_throughput.py's BLR, N={} "
          "D={} float32, {} chains; cuts: kept draws SGLD {} (of 20000), "
          "HMC {} (of 2000), PT {} and ChEES {} (of 1000), warmup {}; SGLD "
          "at step {} (the benchmark's {} is above this posterior's "
          "stability limit 2/lambda_max = {:.4e}: after {} of its steps "
          "max |w| = {:.4e}) with {} burn-in steps | {} | wall {:.3f} s"
          .format(card, MCMC_N, MCMC_D, MCMC_CHAINS, SGLD_DRAWS, HMC_DRAWS,
                  PT_DRAWS, CHEES_DRAWS, MCMC_WARMUP, SGLD_STEP,
                  SGLD_BENCH_STEP, 2.0 / lam_max, SGLD_DIVERGE_STEPS,
                  bench_max, SGLD_BURNIN, " | ".join(lines),
                  time.perf_counter() - t_phase), flush=True)

    # ---- 40. HMC and SVGD over a GP module's noise variance: K1 builds
    # Kxx in every potential evaluation
    t_phase = time.perf_counter()

    # K1 against its plain version at one potential and gradient
    gm = gp_noise_model()
    infr = HMCInference(HMCAlgorithm(model=gm, observed=[gm.X, gm.Y],
                                     num_chains=GP_CHAINS),
                        dtype="float32", device=dev)
    infr.initialize(X=Xe, Y=Ye)
    env = create_sampling_executor(infr.inference_algorithm,
                                   infr.params).build_env(
        infr.params.trainable_params(), infr.params.fixed_params(),
        [Xe, Ye])
    uuids = [gm.noise_var.uuid]
    bij = hmc.make_support_transforms(gm, uuids)
    z = {gm.noise_var.uuid: torch.log(torch.as_tensor(
        np.random.default_rng(seed + 40).gamma(2.0, 1 / 20.0,
                                               (GP_CHAINS, 1)),
        dtype=torch.float32, device=dev))}
    log_post = hmc.log_posterior(gm, hmc.detached_env(env),
                                 RuntimeContext(gen(42)), bij,
                                 torch.float32)
    zero_counts()
    lp_k, g_k = hmc.value_and_grad(log_post, z)
    sync()
    check_launches = read_counts()["K1"]
    cuda_kernels.set_use_kernel(False)
    try:
        lp_p, g_p = hmc.value_and_grad(log_post, z)
        sync()
    finally:
        cuda_kernels.set_use_kernel(True)
    check(check_launches == 1 and read_counts()["K1"] == 1,
          "phase 40: the potential launched K1 {} times, its plain "
          "version {}".format(check_launches,
                              read_counts()["K1"] - check_launches))
    lp_rel = float(torch.max(torch.abs(lp_k - lp_p)) /
                   torch.max(torch.abs(lp_p)))
    (gk,), (gp,) = g_k.values(), g_p.values()
    g_rel = float(torch.max(torch.abs(gk - gp)) / torch.max(torch.abs(gp)))
    check(lp_rel <= EXACT_F64_RTOL and g_rel <= FAMILY_GRAD_RTOL,
          "phase 40: K1 vs plain: log posterior relative {} (tol {}), "
          "gradient {} of its largest entry (tol {})".format(
              lp_rel, EXACT_F64_RTOL, g_rel, FAMILY_GRAD_RTOL))
    # the main path: HMC (4 chains), then SVGD (16 particles)
    zero_counts()
    gm = gp_noise_model()
    t0 = time.perf_counter()
    hinf = HMCInference(HMCAlgorithm(
        model=gm, observed=[gm.X, gm.Y], num_samples=GP_DRAWS,
        num_warmup=GP_WARMUP, num_chains=GP_CHAINS, num_leapfrog=GP_L),
        dtype="float32", device=dev)
    (nv,) = hinf.run(X=Xe, Y=Ye, generator=gen(43)).values()
    sync()
    hmc_s = time.perf_counter() - t0
    hmc_k1 = read_counts()
    transitions = GP_WARMUP + GP_DRAWS
    check(hmc_k1 == dict(none, K1=1 + GP_L * transitions)
          and gm.evaluations == hmc_k1["K1"], "phase 40 HMC: launched {} "
          "in {} potential evaluations; expected K1 = 1 + {}·{}".format(
              hmc_k1, gm.evaluations, GP_L, transitions))
    nv_mean = float(nv.mean())
    check(tuple(nv.shape) == (GP_DRAWS, GP_CHAINS, 1)
          and bool((nv > 0).all()) and 0.005 < nv_mean < 0.05
          and hinf.diagnostics["accept_rate"].min() > 0.5,
          "phase 40 HMC: noise variance draws {} of mean {} (band 0.005 "
          "to 0.05), accept rates {}".format(
              tuple(nv.shape), nv_mean, hinf.diagnostics["accept_rate"]))
    zero_counts()
    gs = gp_noise_model()
    t0 = time.perf_counter()
    (nvs,) = SVGDInference(SVGDAlgorithm(
        model=gs, observed=[gs.X, gs.Y], num_particles=SVGD_PARTICLES,
        num_iterations=GP_SVGD_ITERS, step_size=0.05), dtype="float32",
        device=dev).run(X=Xe, Y=Ye, generator=gen(44)).values()
    sync()
    svgd_s = time.perf_counter() - t0
    svgd_k1 = read_counts()
    check(svgd_k1 == dict(none, K1=GP_SVGD_ITERS)
          and gs.evaluations == GP_SVGD_ITERS, "phase 40 SVGD: launched {} "
          "in {} evaluations; expected K1 = {}".format(
              svgd_k1, gs.evaluations, GP_SVGD_ITERS))
    nvs_mean = float(nvs.mean())
    check(tuple(nvs.shape) == (SVGD_PARTICLES, 1)
          and 0.003 < nvs_mean < 0.06, "phase 40 SVGD: particles {} of "
          "mean {} (band 0.003 to 0.06)".format(tuple(nvs.shape),
                                                 nvs_mean))
    print("phase 40 samplers over a GP module ({}): noise variance under "
          "Gamma(2, 20) in GPRegression(RBF({})) on phase 14's data (N={}, "
          "noise 0.1) | K1 vs plain at one potential and gradient of {} "
          "chains: log posterior rel {:.3e} (tol {:.0e}), gradient {:.3e} "
          "of its largest entry (tol {:.0e}) | HMC {} chains, L={}, {} "
          "warmup + {} kept (cut from the JAX test's 200 + 200 at 2 chains "
          "to fit): K1 {} = 1 + {} per transition, noise variance mean "
          "{:.5f} (band 0.005-0.05), accept rate {:.3f}, max R-hat {:.4f}, "
          "{:.3f} s ({:.2f} ms per potential evaluation) | SVGD {} "
          "particles, {} iterations: K1 {} = 1 per iteration, mean {:.5f} "
          "(band 0.003-0.06), {:.3f} s | wall {:.3f} s".format(
              card, EXACT_D, EXACT_N, GP_CHAINS, lp_rel, EXACT_F64_RTOL,
              g_rel, FAMILY_GRAD_RTOL, GP_CHAINS, GP_L, GP_WARMUP, GP_DRAWS,
              hmc_k1["K1"], GP_L, nv_mean,
              float(np.mean(hinf.diagnostics["accept_rate"])),
              hinf.diagnostics["r_hat_max"], hmc_s,
              1e3 * hmc_s / gm.evaluations, SVGD_PARTICLES, GP_SVGD_ITERS,
              svgd_k1["K1"], nvs_mean, svgd_s,
              time.perf_counter() - t_phase), flush=True)

    # ---- 41. ChEES on a correlated posterior; SVGD, card vs CPU
    t_phase = time.perf_counter()
    Xc, yc = blr_data(np.random.default_rng(seed + 41), CORR_N, MCMC_D,
                      correlated=True)
    _, Sigma_c, _ = blr_posterior(Xc, yc, MCMC_S2)
    eig = np.linalg.eigvalsh(Sigma_c)
    zero_counts()
    mc = counting(blr_model(CORR_N, MCMC_D, MCMC_S2))
    t0 = time.perf_counter()
    cinf = ChEESHMCInference(ChEESHMCAlgorithm(
        model=mc, observed=[mc.X, mc.y], num_samples=CORR_DRAWS,
        num_warmup=CORR_WARMUP, num_chains=MCMC_CHAINS,
        trajectory_length=0.05, step_size=0.05), dtype="float32",
        device=dev)
    cdraws = cinf.run(X=Xc, y=yc, generator=gen(45))[mc.w.uuid]
    sync()
    chees_s = time.perf_counter() - t0
    check(read_counts() == none, "phase 41 ChEES: launched {}".format(
        read_counts()))
    d = cinf.diagnostics
    corr_L = float(d["mean_leapfrog_steps"])
    check(bool(torch.isfinite(cdraws).all()) and corr_L > 1.5,
          "phase 41 ChEES: mean leapfrog steps {} (must exceed 1.5), "
          "finite draws {}".format(corr_L,
                                   bool(torch.isfinite(cdraws).all())))
    init = np.random.default_rng(seed + 46).standard_normal(
        SVGD_PARTICLES * MCMC_D)
    particles = {}
    for where in (dev, torch.device("cpu")):
        ms = blr_model(CORR_N, MCMC_D, MCMC_S2,
                       rand_gen=FixedRandomGenerator(init))
        zero_counts()
        particles[where.type] = SVGDInference(SVGDAlgorithm(
            model=ms, observed=[ms.X, ms.y], num_particles=SVGD_PARTICLES,
            num_iterations=SVGD_CPU_ITERS, step_size=0.1), dtype="float32",
            device=where).run(X=Xc, y=yc, generator=gen(47, where))[
                ms.w.uuid].double().cpu().numpy()
        sync()
        check(read_counts() == none, "phase 41 SVGD: launched {}".format(
            read_counts()))
    z_cpu = particles["cpu"]
    svgd_err = float(np.max(np.abs(particles["cuda"] - z_cpu)))
    check(np.isfinite(particles["cuda"]).all()
          and svgd_err <= SVGD_CPU_RTOL * float(np.max(np.abs(z_cpu))),
          "phase 41 SVGD: card vs CPU max |diff| {} against {} of max |z| "
          "{}".format(svgd_err, SVGD_CPU_RTOL, np.max(np.abs(z_cpu))))
    print("phase 41 correlated posterior ({}): ChEES on "
          "tests/inference/test_chees.py:49-86's design at N={} D={} "
          "(posterior sd {:.3e} to {:.3e}), {} chains, T0 0.05, eps0 0.05, "
          "{} warmup + {} kept (cut from 500 + 500): mean leapfrog steps "
          "{:.3f} (phase 39's {:.3f}; must exceed 1.5), T {:.4e}, eps "
          "{:.4e}, accept rate {:.3f}, max R-hat {:.4f}, {} potential "
          "evaluations in {:.3f} s | SVGD {} particles from fixed draws, {} "
          "iterations, float32, card vs CPU: max |diff| {:.3e} (tol {:.0e} "
          "of max |z| {:.4f}) | wall {:.3f} s".format(
              card, CORR_N, MCMC_D, float(np.sqrt(eig[0])),
              float(np.sqrt(eig[-1])), MCMC_CHAINS, CORR_WARMUP, CORR_DRAWS,
              corr_L, chees_L, float(d["trajectory_length"]),
              float(d["step_size"]), float(np.mean(d["accept_rate"])),
              d["r_hat_max"], mc.evaluations, chees_s, SVGD_PARTICLES,
              SVGD_CPU_ITERS, svgd_err, SVGD_CPU_RTOL,
              float(np.max(np.abs(z_cpu))), time.perf_counter() - t_phase),
          flush=True)
    return hmc_k1["K1"] + svgd_k1["K1"]


def blr_evidence_f64(X, y, noise_var):
    """log N(y | 0, XXᵀ + σ²I) in float64 through H = XᵀX/σ² + I:
    log|σ²I + XXᵀ| = N log σ² + log|H| and yᵀ(σ²I + XXᵀ)⁻¹y =
    (yᵀy − (Xᵀy)ᵀH⁻¹(Xᵀy)/σ²)/σ²."""
    X, y = X.astype(np.float64), y[:, 0].astype(np.float64)
    N = len(y)
    H = X.T @ X / noise_var + np.eye(X.shape[1])
    Xty = X.T @ y
    quad = (y @ y - Xty @ np.linalg.solve(H, Xty) / noise_var) / noise_var
    return float(-0.5 * N * math.log(2.0 * math.pi)
                 - 0.5 * (N * math.log(noise_var)
                          + np.linalg.slogdet(H)[1]) - 0.5 * quad)


def svgp_gamma_noise(Z0):
    """Phase 6's SVGP with its noise variance a Gamma(2, 20) latent."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import Gamma
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.modules import SVGPRegression
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.noise_var = Gamma.define_variable(alpha=2.0, beta=20.0, shape=(1,))
    m.Y = SVGPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=D, variance=1.0,
                          lengthscale=math.sqrt(D)),
        noise_var=m.noise_var, shape=(m.n, 1),
        inducing_inputs=Variable(shape=(M, D), initial_value=Z0))
    return m


def at_float64_on_cpu(inf, data):
    """A float64 CPU inference of ``inf``'s algorithm at its state."""
    import torch
    from mxfusion_tpu_torch.inference import GradBasedInference
    out = GradBasedInference(inf.inference_algorithm, dtype="float64",
                             device="cpu")
    out.initialize(**data)
    out.params.update_params({k: v.detach().to("cpu", torch.float64)
                              for k, v in inf.params.param_dict.items()})
    return out


def evidence_phases(dev, card, seed, Xe, Ye, Xtr, Ytr, read_counts,
                    zero_counts, sync):
    """Phases 42-45: Laplace, thermodynamic integration, WAIC/PSIS-LOO
    and the predictive check, observation masks. Returns the launches of
    K1-K3 on their main paths (the MAP fits and the Laplace passes over
    the GP and the SVGP, the power posterior over the GP)."""
    import torch
    from scipy.special import gammaln
    from mxfusion_tpu_torch import Model
    from mxfusion_tpu_torch.components.distributions import (Exponential,
                                                             Gamma)
    from mxfusion_tpu_torch.components.functions.operators import \
        broadcast_to
    from mxfusion_tpu_torch.inference import (
        GradBasedInference, MAP, PowerPosteriorAlgorithm,
        PowerPosteriorInference, RuntimeContext, SGLDAlgorithm,
        SGLDInference, create_sampling_executor, laplace_approximation,
        loo_psis, pointwise_log_likelihood, posterior_predictive_check,
        waic)
    from mxfusion_tpu_torch.inference import hmc
    from mxfusion_tpu_torch.ops import cuda_kernels
    none = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    main = dict(none)

    def gen(k, device=dev):
        return torch.Generator(device).manual_seed(seed + k)

    def tally(counts):
        for k, v in counts.items():
            main[k] += v
        return counts

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def map_inference(m, observed):
        return GradBasedInference(MAP(model=m, observed=observed),
                                  dtype="float32", device=dev)

    # ---- 42. Laplace
    t_phase = time.perf_counter()
    # (a) BLR at phase 39's width, at the float64 mode
    X, y = blr_data(np.random.default_rng(seed), MCMC_N, MCMC_D)
    mu, Sigma, _ = blr_posterior(X, y, MCMC_S2)
    m = blr_model(MCMC_N, MCMC_D, MCMC_S2)
    inf = map_inference(m, [m.X, m.y])
    inf.initialize(X=X, y=y)
    inf.params[inf.inference_algorithm.posterior[m.w].factor.location] = \
        mu.astype(np.float32)[:, None]
    zero_counts()
    lap, blr_s = timed(lambda: laplace_approximation(inf, X=X, y=y))
    check(read_counts() == none, "phase 42a: Laplace on the BLR launched "
          "{}".format(read_counts()))
    cov = lap.marginal(m.w)[1].double().cpu().numpy()
    cov_err = float(np.max(np.abs(cov - Sigma)) / np.max(np.abs(Sigma)))
    exact = blr_evidence_f64(X, y, MCMC_S2)
    blr_rel = abs(lap.log_evidence - exact) / abs(exact)
    check(cov_err <= LAP_COV_TOL and blr_rel <= LAP_BLR_RTOL,
          "phase 42a: Laplace on the BLR: Σ off the float64 closed form by "
          "{} of its largest entry (tol {}), log evidence {} vs {}: "
          "relative {} (tol {})".format(cov_err, LAP_COV_TOL,
                                        lap.log_evidence, exact, blr_rel,
                                        LAP_BLR_RTOL))
    # (b) GPRegression at phase 14's N = 1024, D = 4, a Gamma noise latent
    gm = gp_noise_model()
    gloop = recording_batch_loop(read_counts, sync)
    ginf = GradBasedInference(MAP(model=gm, observed=[gm.X, gm.Y]),
                              grad_loop=gloop, dtype="float32", device=dev)
    zero_counts()
    _, gp_map_s = timed(lambda: ginf.run(
        X=Xe, Y=Ye, max_iter=LAP_GP_STEPS, learning_rate=LAP_GP_LR,
        generator=gen(42)))
    gp_map = tally(read_counts())
    check(gp_map == dict(none, K1=LAP_GP_STEPS), "phase 42b: {} MAP steps "
          "launched {}; expected K1 once a step".format(LAP_GP_STEPS,
                                                         gp_map))
    gp_step_ms = 1e3 * np.percentile(gloop.wall_s[1:], [25, 50, 75])
    zero_counts()
    glap, gp_lap_s = timed(lambda: laplace_approximation(ginf, X=Xe, Y=Ye))
    gp_lap = tally(read_counts())
    check(gp_lap["K1"] >= 1 and gp_lap == dict(none, K1=gp_lap["K1"]),
          "phase 42b: Laplace over the GP launched {}; K1 builds Kxx in "
          "its passes".format(gp_lap))
    glap64 = laplace_approximation(at_float64_on_cpu(ginf, {"X": Xe,
                                                            "Y": Ye}),
                                   X=Xe, Y=Ye)
    gp_rel = abs(glap.log_evidence - glap64.log_evidence) / \
        abs(glap64.log_evidence)
    nv_var = float(glap.marginal(gm.noise_var)[1][0, 0])
    nv_var64 = float(glap64.marginal(gm.noise_var)[1][0, 0])
    var_rel = abs(nv_var - nv_var64) / abs(nv_var64)
    nv = float(glap.marginal(gm.noise_var)[0][0])
    check(gp_rel <= LAP_GP_RTOL and var_rel <= LAP_GP_VAR_RTOL,
          "phase 42b: Laplace over the GP, float32 on the card vs float64 "
          "on the CPU at the same MAP point: log evidence {} vs {} "
          "(relative {}, tol {}), marginal variance {} vs {} (relative {}, "
          "tol {})".format(glap.log_evidence, glap64.log_evidence, gp_rel,
                           LAP_GP_RTOL, nv_var, nv_var64, var_rel,
                           LAP_GP_VAR_RTOL))
    # (c) phase 6's SVGP on 65536 rows with a Gamma noise latent
    Xs, Ys = Xtr[:LAP_SVGP_N], Ytr[:LAP_SVGP_N]
    sm = svgp_gamma_noise(np.random.default_rng(seed + 42).uniform(
        0.0, BOX, (M, D)))
    sinf = map_inference(sm, [sm.X, sm.Y])
    zero_counts()
    _, svgp_map_s = timed(lambda: sinf.run(
        X=Xs, Y=Ys, max_iter=LAP_SVGP_STEPS, learning_rate=3e-3,
        generator=gen(43)))
    svgp_map = tally(read_counts())
    check(svgp_map == dict(none, K1=LAP_SVGP_STEPS, K2=LAP_SVGP_STEPS,
                           K3=3 * LAP_SVGP_STEPS),
          "phase 42c: {} fused MAP steps launched {}; expected K1/K2/K3 "
          "1/1/3 a step".format(LAP_SVGP_STEPS, svgp_map))
    zero_counts()
    slap, svgp_lap_s = timed(lambda: laplace_approximation(sinf, X=Xs,
                                                           Y=Ys))
    svgp_lap = tally(read_counts())
    check(svgp_lap["K1"] >= 1 and svgp_lap == dict(none,
                                                   K1=svgp_lap["K1"]),
          "phase 42c: Laplace over the SVGP launched {}; expected K1 and "
          "no K2/K3 (the fused arm off for the pass)".format(svgp_lap))
    slap64 = laplace_approximation(at_float64_on_cpu(sinf, {"X": Xs,
                                                            "Y": Ys}),
                                   X=Xs, Y=Ys)
    svgp_rel = abs(slap.log_evidence - slap64.log_evidence) / \
        abs(slap64.log_evidence)
    check(svgp_rel <= LAP_SVGP_RTOL, "phase 42c: Laplace over the SVGP: "
          "log evidence {} vs float64 {} (relative {}, tol {})".format(
              slap.log_evidence, slap64.log_evidence, svgp_rel,
              LAP_SVGP_RTOL))
    print("phase 42 laplace ({}): (a) BLR N={} D={} float32 at the float64 "
          "mode: {:.3f} s, Σ off the closed form by {:.3e} of its largest "
          "entry (tol {:.0e}), log evidence {:.6f} vs {:.6f} (rel {:.3e}, "
          "tol {:.0e}), no launch | (b) GPRegression(RBF({})) N={}, noise "
          "~ Gamma(2, 20): MAP {} steps {:.3f} s (K1 {}; step wall ms "
          "quartiles after the first {}, losses {:.4f} -> {:.4f}), Laplace "
          "{:.3f} s "
          "(K1 {}), noise variance {:.6f} ± {:.3e}, log evidence {:.6f} vs "
          "float64 on the CPU {:.6f} (rel {:.3e}, tol {:.0e}), marginal "
          "variance rel {:.3e} (tol {:.0e}) | (c) SVGP M={} D={} on {} "
          "rows, noise ~ Gamma(2, 20): {} fused MAP steps {:.3f} s ({}), "
          "Laplace {:.3f} s ({}), log evidence {:.4f} vs float64 {:.4f} "
          "(rel {:.3e}, tol {:.0e}) | wall {:.3f} s".format(
              card, MCMC_N, MCMC_D, blr_s, cov_err, LAP_COV_TOL,
              lap.log_evidence, exact, blr_rel, LAP_BLR_RTOL, EXACT_D,
              EXACT_N, LAP_GP_STEPS, gp_map_s, gp_map["K1"],
              [round(float(v), 3) for v in gp_step_ms], gloop.losses[0],
              gloop.losses[-1], gp_lap_s,
              gp_lap["K1"], nv, math.sqrt(nv_var), glap.log_evidence,
              glap64.log_evidence, gp_rel, LAP_GP_RTOL, var_rel,
              LAP_GP_VAR_RTOL, M, D, LAP_SVGP_N, LAP_SVGP_STEPS,
              svgp_map_s, svgp_map, svgp_lap_s, svgp_lap,
              slap.log_evidence, slap64.log_evidence, svgp_rel,
              LAP_SVGP_RTOL, time.perf_counter() - t_phase), flush=True)

    # ---- 43. thermodynamic integration
    t_phase = time.perf_counter()
    # (a) over 42b's GP, at its MAP kernel hyperparameters
    def gp_ti_inference(warmup, draws):
        ti = PowerPosteriorInference(PowerPosteriorAlgorithm(
            model=gm, observed=[gm.X, gm.Y], num_samples=draws,
            num_warmup=warmup, num_chains=TI_C, num_temps=TI_K,
            num_leapfrog=TI_L), dtype="float32", device=dev)
        ti.initialize(X=Xe, Y=Ye)
        ti.params.update_params({u: v for u, v in
                                 ginf.params.param_dict.items()
                                 if u in ti.params.param_dict})
        return ti

    def gp_ti(warmup, draws, k):
        ti = gp_ti_inference(warmup, draws)
        ti.run(X=Xe, Y=Ye, generator=gen(k))
        return ti

    @contextlib.contextmanager
    def k1_shapes():
        """The shape of every gram K1 launches inside the block."""
        shapes, launch = [], cuda_kernels._rbf_cuda

        def recorded(X, X2, lengthscale, variance):
            K = launch(X, X2, lengthscale, variance)
            shapes.append(tuple(K.shape))
            return K
        cuda_kernels._rbf_cuda = recorded
        try:
            yield shapes
        finally:
            cuda_kernels._rbf_cuda = launch

    # K1 against its plain version at one power-posterior potential and
    # gradient over the C·K replicas
    ti0 = gp_ti_inference(0, 1)
    alg = ti0.inference_algorithm
    env = create_sampling_executor(alg, ti0.params).build_env(
        ti0.params.trainable_params(), ti0.params.fixed_params(), [Xe, Ye])
    uuids = [gm.noise_var.uuid]
    bij = hmc.make_support_transforms(gm, uuids)
    parts = alg.potential_parts(hmc.detached_env(env),
                                RuntimeContext(gen(43)), bij, torch.float32)
    betas = alg.ladder(torch.float32, dev)
    z = {gm.noise_var.uuid: torch.log(torch.as_tensor(
        np.random.default_rng(seed + 43).gamma(2.0, 1 / 20.0,
                                               (TI_C * TI_K, 1)),
        dtype=torch.float32, device=dev))}
    liks = []

    def potential(q):
        pri, lik = parts(q)
        liks.append(lik.detach())
        return -(pri + betas * lik)

    zero_counts()
    with k1_shapes() as check_shapes:
        u_k, g_k = hmc.value_and_grad(potential, z)
        sync()
    check_launches = read_counts()["K1"]
    cuda_kernels.set_use_kernel(False)
    try:
        u_p, g_p = hmc.value_and_grad(potential, z)
        sync()
    finally:
        cuda_kernels.set_use_kernel(True)
    gram = (TI_C * TI_K, EXACT_N, EXACT_N)
    check(check_launches == 1 and read_counts()["K1"] == 1
          and check_shapes == [gram], "phase 43a: the potential launched "
          "K1 {} times at {}, its plain version {} (expected once at {})"
          .format(check_launches, check_shapes,
                  read_counts()["K1"] - check_launches, gram))
    u_rel = float(torch.max(torch.abs(u_k - u_p)) /
                  torch.max(torch.abs(u_p)))
    lik_rel = float(torch.max(torch.abs(liks[0] - liks[1])) /
                    torch.max(torch.abs(liks[1])))
    (gk,), (gp,) = g_k.values(), g_p.values()
    g_rel = float(torch.max(torch.abs(gk - gp)) / torch.max(torch.abs(gp)))
    check(u_rel <= EXACT_F64_RTOL and lik_rel <= EXACT_F64_RTOL
          and g_rel <= FAMILY_GRAD_RTOL,
          "phase 43a: K1 vs plain over {} replicas: potential relative {}, "
          "log likelihood {} (tol {}), gradient {} of its largest entry "
          "(tol {})".format(TI_C * TI_K, u_rel, lik_rel, EXACT_F64_RTOL,
                            g_rel, FAMILY_GRAD_RTOL))
    # the main path
    zero_counts()
    with k1_shapes() as ti_shapes:
        ti, ti_s = timed(lambda: gp_ti(TI_WARMUP, TI_DRAWS, 44))
    ti_k1 = tally(read_counts())
    evals = int(ti.diagnostics["potential_evaluations"])
    sweeps = TI_WARMUP + TI_DRAWS
    ti_grams = sorted(set(ti_shapes))
    check(ti_k1 == dict(none, K1=evals) and evals == 1 + (TI_L + 1) * sweeps
          and len(ti_shapes) == evals and ti_grams == [gram],
          "phase 43a: the power posterior launched {} in {} potential "
          "evaluations at grams {}; expected K1 once an evaluation, "
          "1 + {}·{}, at {}".format(ti_k1, evals, ti_grams, TI_L + 1,
                                    sweeps, gram))
    ti_gap = abs(ti.log_evidence - glap.log_evidence)
    check(math.isfinite(ti.log_evidence) and ti_gap <= TI_ATOL,
          "phase 43a: TI log evidence {} vs Laplace {}: |diff| {} (bound "
          "{})".format(ti.log_evidence, glap.log_evidence, ti_gap, TI_ATOL))
    prof = profile_window(lambda: gp_ti(0, 5, 45), ROOT / "build" /
                          "chip_smoke_ti_trace.json")
    # (b) the Gamma-Exponential oracle of test_evidence.py:21-41
    rng = np.random.default_rng(1)
    n_ge = 60
    y_ge = rng.exponential(1.0 / 1.7, (n_ge, 1))
    me = Model()
    me.tau = Gamma.define_variable(alpha=2.0, beta=2.0, shape=(1,))
    me.y = Exponential.define_variable(rate=broadcast_to(me.tau, (n_ge, 1)),
                                       shape=(n_ge, 1))
    zero_counts()
    ge = PowerPosteriorInference(PowerPosteriorAlgorithm(
        model=me, observed=[me.y], num_samples=TI_GE_DRAWS,
        num_warmup=TI_GE_WARMUP, num_chains=2, num_temps=16),
        dtype="float32", device=dev)
    (tau,), ge_s = timed(lambda: ge.run(y=y_ge, generator=gen(46)).values())
    check(read_counts() == none, "phase 43b: launched {}".format(
        read_counts()))
    a = b = 2.0
    ge_exact = (a * math.log(b) + gammaln(a + n_ge) - gammaln(a)
                - (a + n_ge) * math.log(b + y_ge.sum()))
    tau_mean, tau_exact = float(tau.mean()), (a + n_ge) / (b + y_ge.sum())
    swap_min = float(ge.diagnostics["swap_accept_rate"].min())
    check(abs(ge.log_evidence - ge_exact) <= TI_GE_ATOL
          and abs(tau_mean - tau_exact) <= TI_GE_RTOL * tau_exact
          and swap_min > 0.3, "phase 43b: TI {} vs closed form {} (tol {}), "
          "tau mean {} vs {} (rtol {}), smallest swap acceptance {} (must "
          "exceed 0.3)".format(ge.log_evidence, ge_exact, TI_GE_ATOL,
                               tau_mean, tau_exact, TI_GE_RTOL, swap_min))
    print("phase 43 thermodynamic integration ({}): (a) over 42b's GP at its "
          "MAP hyperparameters, {} chains x {} rungs (c = 5), L={}, {} + {} "
          "sweeps (cut from 400 + 600): {} potential evaluations ({} a "
          "sweep), K1 {} at the measured grams {}, {:.3f} s, {:.1f} "
          "evaluations/s; K1 vs plain at one potential over the {} "
          "replicas: relative {:.3e}, log likelihood {:.3e}, gradient "
          "{:.3e}; log evidence {:.4f} vs Laplace {:.4f}: |diff| {:.4f} (bound {}); "
          "swap acceptance by pair {}; adapted eps at beta=1 {:.4e}; profile "
          "of 5 sweeps: {} | (b) Gamma-Exponential (N={}), {} + {} sweeps "
          "(of 400 + 600): {:.4f} vs closed form {:.4f} (tol {}), tau mean "
          "{:.4f} vs {:.4f}, smallest swap acceptance {:.3f}, {:.3f} s | "
          "wall {:.3f} s".format(
              card, TI_C, TI_K, TI_L, TI_WARMUP, TI_DRAWS, evals, TI_L + 1,
              ti_k1["K1"], ti_grams, ti_s, evals / ti_s, TI_C * TI_K, u_rel,
              lik_rel, g_rel,
              ti.log_evidence, glap.log_evidence, ti_gap, TI_ATOL,
              [round(float(v), 3) for v in ti.diagnostics[
                  "swap_accept_rate"]],
              float(ti.diagnostics["step_size"][0]),
              profile_summary(prof, 5), n_ge, TI_GE_WARMUP, TI_GE_DRAWS,
              ge.log_evidence, ge_exact, TI_GE_ATOL, tau_mean, tau_exact,
              swap_min, ge_s, time.perf_counter() - t_phase), flush=True)

    # ---- 44. model comparison on phase 39's BLR by SGLD
    t_phase = time.perf_counter()
    results = {}
    for label, d in (("true", MCMC_D), ("misspecified", MC_MIS_D)):
        mm = blr_model(MCMC_N, d, MCMC_S2, symbolic=True)
        Xd = np.ascontiguousarray(X[:, :d])
        sg = SGLDInference(SGLDAlgorithm(
            model=mm, observed=[mm.X, mm.y], num_samples=MC_DRAWS,
            num_burnin=SGLD_BURNIN, thin=MC_THIN, num_chains=MCMC_CHAINS,
            batch_size=SGLD_B, step_size=SGLD_STEP, step_decay_gamma=0.0),
            dtype="float32", device=dev)
        zero_counts()
        _, sgld_s = timed(lambda: sg.run(X=Xd, y=y, generator=gen(47)))
        ll, ll_s = timed(lambda: pointwise_log_likelihood(sg, X=Xd, y=y)[
            "y"])
        check(tuple(ll.shape) == (MC_DRAWS * MCMC_CHAINS, MCMC_N)
              and ll.is_cuda and bool(torch.isfinite(ll).all()),
              "phase 44 {}: pointwise log-likelihood {} on {}, finite {}"
              .format(label, tuple(ll.shape), ll.device,
                      bool(torch.isfinite(ll).all())))
        check(sg.params.constants[mm.n.uuid] == SGLD_B, "phase 44 {}: the "
              "data dim came back bound to {}".format(
                  label, sg.params.constants[mm.n.uuid]))
        w, waic_s = timed(lambda: waic(ll))
        lo, loo_s = timed(lambda: loo_psis(ll))
        check(read_counts() == none, "phase 44 {}: launched {}".format(
            label, read_counts()))
        results[label] = (sg, mm, Xd, ll, w, lo, sgld_s, ll_s, waic_s,
                          loo_s)
    sg, mm, _, ll, w, lo = results["true"][:6]
    sub = ll[:, :MC_SUBSET].cpu()
    w_cpu, lo_cpu = waic(sub), loo_psis(sub)
    diffs = {}
    for name, card_v, cpu_v in (
            ("waic", w["pointwise"][:MC_SUBSET], w_cpu["pointwise"]),
            ("loo", lo["pointwise"][:MC_SUBSET], lo_cpu["pointwise"]),
            ("pareto_k", lo["pareto_k"][:MC_SUBSET], lo_cpu["pareto_k"])):
        a_, b_ = card_v.cpu().numpy(), cpu_v.numpy()
        diffs[name] = float(np.max(np.abs(a_ - b_) / np.maximum(
            np.abs(b_), 1.0 if name == "pareto_k" else 1e-300)))
    check(max(diffs.values()) <= MC_CPU_RTOL, "phase 44: WAIC/LOO on the "
          "card vs the CPU on {} columns: largest relative difference {} "
          "(tol {})".format(MC_SUBSET, diffs, MC_CPU_RTOL))
    w_mis, lo_mis = results["misspecified"][4:6]
    k_ok = float((lo["pareto_k"] < 0.7).double().mean())
    check(w["elpd_waic"] > w_mis["elpd_waic"]
          and lo["elpd_loo"] > lo_mis["elpd_loo"] and k_ok > 0.9,
          "phase 44: elpd true vs misspecified: WAIC {} vs {}, LOO {} vs "
          "{}; share of Pareto k < 0.7 {} (must exceed 0.9)".format(
              w["elpd_waic"], w_mis["elpd_waic"], lo["elpd_loo"],
              lo_mis["elpd_loo"], k_ok))
    ppc, ppc_s = timed(lambda: posterior_predictive_check(
        sg, lambda r: r.var(correction=0), "y", generator=gen(48),
        X=results["true"][2], y=y))
    check(0.05 < ppc["p_value"] < 0.95 and len(ppc["T_rep"]) ==
          MC_DRAWS * MCMC_CHAINS, "phase 44: predictive check of var(y): "
          "p = {} over {} replicates (band 0.05-0.95)".format(
              ppc["p_value"], len(ppc["T_rep"])))
    print("phase 44 model comparison ({}): phase 39's BLR (N={}), SGLD {} "
          "chains at step {}, B={}, {} burn-in, thin {}, {} draws a chain, "
          "against a misspecified model on the first {} of {} features | "
          "{} | WAIC/LOO on the card vs the CPU on {} columns: relative "
          "{} (tol {:.0e}) | Pareto k < 0.7 for {:.4f} of the points | "
          "predictive check of var(y): p = {:.3f}, T_obs {:.4f}, {:.3f} s | "
          "wall {:.3f} s".format(
              card, MCMC_N, MCMC_CHAINS, SGLD_STEP, SGLD_B, SGLD_BURNIN,
              MC_THIN, MC_DRAWS, MC_MIS_D, MCMC_D, " | ".join(
                  "{}: SGLD {:.3f} s, pointwise ({}, {}) in {:.3f} s, "
                  "elpd_waic {:.2f} (p_waic {:.2f}, se {:.2f}) in {:.3f} s, "
                  "elpd_loo {:.2f} (p_loo {:.2f}) in {:.3f} s".format(
                      label, r[6], r[3].shape[0], r[3].shape[1], r[7],
                      r[4]["elpd_waic"], r[4]["p_waic"], r[4]["se"], r[8],
                      r[5]["elpd_loo"], r[5]["p_loo"], r[9])
                  for label, r in results.items()),
              MC_SUBSET, {k: float("{:.3e}".format(v))
                          for k, v in diffs.items()},
              MC_CPU_RTOL, k_ok, ppc["p_value"], ppc["T_obs"], ppc_s,
              time.perf_counter() - t_phase), flush=True)
    del results, ll, sub

    # ---- 45. observation masks on phase 39's BLR
    t_phase = time.perf_counter()
    mrng = np.random.default_rng(seed + 45)
    mask = (mrng.random((MCMC_N, 1)) >= MASK_SHARE).astype(np.float32)
    keep = mask[:, 0] > 0
    y_masked = np.where(mask > 0, y, np.float32(1e6)).astype(np.float32)
    mm = blr_model(MCMC_N, MCMC_D, MCMC_S2, symbolic=True)
    start = map_inference(mm, [mm.X, mm.y])
    start.initialize(X=X, y=y_masked, generator=gen(49))
    state = {k: v.detach().clone() for k, v in
             start.params.trainable_params().items()}
    alg = start.inference_algorithm
    zero_counts()
    masked = loss_and_grad_at(alg, state, [X, y_masked], "float32", dev,
                              grad=False, rv_scaling={mm.y.uuid: mask})[0]
    subset = loss_and_grad_at(alg, state, [X[keep], y[keep]], "float32",
                              dev, grad=False)[0]
    obj_rel = abs(masked - subset) / abs(subset)
    check(math.isfinite(masked) and obj_rel <= MASK_OBJ_RTOL,
          "phase 45: masked objective {} vs the observed subset's {}: "
          "relative {} (tol {})".format(masked, subset, obj_rel,
                                        MASK_OBJ_RTOL))
    losses = {}
    for label, data, scaling in (
            ("masked", {"X": X, "y": y_masked}, {mm.y: mask}),
            ("subset", {"X": X[keep], "y": y[keep]}, None)):
        loop = recording_batch_loop(read_counts, sync)
        GradBasedInference(MAP(model=mm, observed=[mm.X, mm.y]),
                           grad_loop=loop, dtype="float32", device=dev).run(
            max_iter=MASK_STEPS, learning_rate=MASK_LR, generator=gen(49),
            rv_scaling=scaling, **data)
        losses[label] = (loop.losses, loop.start_state, loop.wall_s)
    (lm, sm_, wm), (ls, ss, ws) = losses["masked"], losses["subset"]
    # each run has its own MAP posterior, so the locations' uuids differ
    check(len(sm_) == len(ss) and all(
        torch.equal(a_, b_) for a_, b_ in zip(sm_.values(), ss.values())),
        "phase 45: the two MAP runs start from different states")
    step_rel = max(abs(a_ - b_) / abs(b_) for a_, b_ in zip(lm, ls))
    check(len(lm) == len(ls) == MASK_STEPS and step_rel <= MASK_STEP_RTOL
          and read_counts() == none, "phase 45: MAP on the masked data vs "
          "the subset: per-step losses relative {} (tol {}), launches {}"
          .format(step_rel, MASK_STEP_RTOL, read_counts()))
    print("phase 45 masks ({}): phase 39's BLR (N={}, D={}), {:.0%} of y "
          "masked by an (N, 1) mask and set to 1e6, {} kept | objective at "
          "one state masked {:.6f} vs subset {:.6f}: rel {:.3e} (tol "
          "{:.0e}) | MAP by Adam (lr {}) from one start, {} steps: largest "
          "per-step relative difference {:.3e} (tol {:.0e}), losses {} -> "
          "{}, step wall ms median masked {:.3f} subset {:.3f} | wall {:.3f} "
          "s".format(card, MCMC_N, MCMC_D, MASK_SHARE, int(keep.sum()),
                     masked, subset, obj_rel, MASK_OBJ_RTOL, MASK_LR,
                     MASK_STEPS, step_rel, MASK_STEP_RTOL, round(lm[0], 3),
                     round(lm[-1], 3), 1e3 * float(np.median(wm[1:])),
                     1e3 * float(np.median(ws[1:])),
                     time.perf_counter() - t_phase), flush=True)
    return main


def kalman_system(rng):
    """Phase 46's system, float64 numpy: (A, H, Q, R, m0, P0)."""
    A = 0.9 * np.eye(KF_D) + 0.05 * rng.standard_normal((KF_D, KF_D))
    H = rng.standard_normal((KF_E, KF_D))
    Q = 0.05 * np.eye(KF_D) + 0.01 * np.ones((KF_D, KF_D))
    return A, H, Q, 0.1 * np.eye(KF_E), np.zeros(KF_D), np.eye(KF_D)


def kalman_data(rng, system, T):
    """T observations of ``system`` (float64), simulated in numpy."""
    A, H, Q, R, m0, P0 = system
    w = rng.standard_normal((T, KF_D)) @ np.linalg.cholesky(Q).T
    x = np.zeros((T, KF_D))
    x[0] = m0 + np.linalg.cholesky(P0) @ rng.standard_normal(KF_D)
    for t in range(1, T):
        x[t] = A @ x[t - 1] + w[t]
    return x @ H.T + rng.standard_normal((T, KF_E)) @ \
        np.linalg.cholesky(R).T


def kalman_loglik_np(y, mask, system):
    """The log-likelihood of ``y`` under ``system`` with the steps where
    ``mask`` is 0 skipped, by a sequential filter in float64 numpy: an
    oracle independent of the port, as
    tests/components/distributions/test_ssm.py's ``_np_filter_masked``."""
    A, H, Q, R, m, P = system
    ll = 0.0
    for t in range(len(y)):
        if t > 0:
            m, P = A @ m, A @ P @ A.T + Q
        if mask[t] > 0:
            S = H @ P @ H.T + R
            innov = y[t] - H @ m
            ll -= 0.5 * (len(innov) * math.log(2 * math.pi)
                         + np.linalg.slogdet(S)[1]
                         + innov @ np.linalg.solve(S, innov))
            K = np.linalg.solve(S, H @ P).T
            m, P = m + K @ innov, P - K @ H @ P
    return ll


def ssm_model(system, T, parallel):
    """tests/goldens/configs.py:236-265's model at phase 46's widths: A a
    parameter from 0.5·I, the rest of ``system`` constants."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import \
        LinearGaussianSSM
    _, H, Q, R, m0, P0 = system
    m = Model()
    m.A = Variable(shape=(KF_D, KF_D), initial_value=np.eye(KF_D) * 0.5)
    m.y = LinearGaussianSSM.define_variable(
        A=m.A, H=Variable(value=H), trans_cov=Variable(value=Q),
        obs_cov=Variable(value=R), initial_mean=Variable(value=m0),
        initial_cov=Variable(value=P0), shape=(T, KF_E),
        parallel_filter=parallel, dtype="float32")
    return m


def sv_data(rng, T):
    """examples/stochastic_volatility.py's simulation: a log-volatility
    AR(1) path (phi 0.95, sd 0.25) and returns y_t ~ N(0, exp(x_t))."""
    x = np.zeros(T)
    x[0] = -1.0 + 0.5 * rng.standard_normal()
    for t in range(1, T):
        x[t] = 0.95 * x[t - 1] + 0.25 * rng.standard_normal()
    return x, np.exp(x / 2) * rng.standard_normal(T)


def sv_model(T):
    """examples/stochastic_volatility.py's model."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import (GaussianAR1,
                                                             Normal)
    from mxfusion_tpu_torch.components.functions.operators import exp
    m = Model()
    m.x = GaussianAR1.define_variable(
        phi=Variable(value=0.95), noise_var=Variable(value=0.25 ** 2),
        init_mean=Variable(value=-1.0), init_var=Variable(value=1.0),
        shape=(T,))
    m.y = Normal.define_variable(mean=Variable(value=np.zeros(T)),
                                 variance=exp(m.x), shape=(T,))
    return m


def pilco_dynamics(d_in, d_out):
    """examples/pilco/pilco_example.py's dynamics model: GPRegression
    with an RBF over the state-action inputs."""
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.modules import GPRegression
    m = Model()
    m.N = Variable()
    m.X = Variable(shape=(m.N, d_in))
    m.noise_var = Variable(transformation=PositiveTransformation(),
                           initial_value=0.01)
    m.Y = GPRegression.define_variable(
        X=m.X, kernel=RBF(input_dim=d_in, variance=1., lengthscale=1.),
        noise_var=m.noise_var, shape=(m.N, d_out))
    return m


def pilco_inference(m, dyn, horizon, s0, loop, dev):
    """The example's PILCO: a linear policy a = s·w (w from 0), the cost
    Σ s², rolled out from the states ``s0`` over ``horizon`` steps."""
    import torch
    from mxfusion_tpu_torch import Variable
    from mxfusion_tpu_torch.inference import (GradTransferInference,
                                              PILCOAlgorithm)
    m.policy_w = Variable(shape=(s0.shape[1], 1),
                          initial_value=np.zeros((s0.shape[1], 1)))
    s0 = torch.as_tensor(s0, dtype=torch.float32, device=dev)

    def policy(s, env):
        return torch.einsum("...i,ij->...j", s, env[m.policy_w.uuid][0])

    def cost(s, a, env):
        return torch.sum(torch.square(s))

    alg = PILCOAlgorithm(model=m, observed=[], cost_function=cost,
                         policy=policy, n_time_steps=horizon,
                         initial_state_generator=lambda k: s0[:k],
                         num_samples=s0.shape[0])
    return GradTransferInference(inference_algorithm=alg,
                                 infr_params=dyn.params, grad_loop=loop,
                                 dtype="float32", device=dev)


def state_space_phases(dev, card, seed, read_counts, zero_counts, sync):
    """Phases 46-49: the Kalman ops, SSM MAP, stochastic volatility by
    HMC and PILCO. Returns K1's launches on the main paths (phase 49's
    dynamics fits and policy steps)."""
    import warnings
    import torch
    from mxfusion_tpu_torch.inference import (
        GradBasedInference, HMCAlgorithm, HMCInference, MAP,
        create_executor)
    from mxfusion_tpu_torch.ops import cuda_kernels, kalman
    none = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}

    def gen(k, device=dev):
        return torch.Generator(device).manual_seed(seed + k)

    def rel(a, b):
        return abs(a - b) / abs(b)

    # ---- 46. the Kalman ops
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 46)
    system = kalman_system(rng)
    rho = float(np.max(np.abs(np.linalg.eigvals(system[0]))))
    check(rho < 1.0, "phase 46: A's spectral radius {}".format(rho))
    y = kalman_data(rng, system, KF_T_PAR)
    mask = (rng.random(KF_T_LONG) >= KF_MASK_SHARE).astype(np.float64)
    # the masked steps' placeholders are far off: the filter skips them
    y_masked = np.where(mask[:, None] > 0, y[:KF_T_LONG], 1e6)

    def on(T, dtype=torch.float32, device=dev, data=None, grad=False):
        a = [torch.as_tensor(v, dtype=dtype, device=device)
             for v in (y[:T] if data is None else data,) + system]
        for i in (1, 3, 4):          # A, Q and R
            a[i].requires_grad_(grad)
        return a

    def run(filt, args, grad=False, **kw):
        """The filter's outputs and the wall of one evaluation (and of
        its backward into A, Q and R with ``grad``)."""
        sync()
        t0 = time.perf_counter()
        out = filt(*args, **kw)
        if grad:
            out["loglik"].backward()
        sync()
        return out, time.perf_counter() - t0

    def ll_rel(out, ref, label):
        ll = out["loglik"].detach().double().cpu().numpy()
        err = float(np.max(np.abs(ll - ref) / np.abs(ref)))
        check(err <= KF_LL_RTOL, "phase 46: {}: float32 log-likelihood {} "
              "vs float64 {}: relative {} (tol {})".format(
                  label, ll, ref, err, KF_LL_RTOL))
        return err

    seq, par = kalman.kalman_filter, kalman.kalman_filter_parallel
    zero_counts()
    for filt in (seq, par):          # warm-up: handles, kernels, allocator
        run(filt, on(64, grad=True), grad=True)
    # no step of the sequential filter (forward, backward, masked) and
    # of the smoother waits for the host
    small = on(256, grad=True)
    mask_small = torch.as_tensor(mask[:256], dtype=torch.float32,
                                 device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = seq(*small, mask=mask_small)
        out["loglik"].backward()
        kalman.rts_smoother(out["filtered_means"], out["filtered_covs"],
                            out["pred_means"], out["pred_covs"], small[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as par_syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            par(*small)["loglik"].backward()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sync()
    # float64 on the CPU: the port's parallel filter, and a numpy filter
    # (it agrees with the first at T = 1024) for the masked series
    refs = {T: float(par(*on(T, torch.float64, "cpu"))["loglik"])
            for T in (KF_T_SHORT, KF_T_LONG, KF_T_PAR)}
    ref_np = kalman_loglik_np(y[:KF_T_SHORT], np.ones(KF_T_SHORT), system)
    check(rel(ref_np, refs[KF_T_SHORT]) <= 1e-9, "phase 46: float64 on "
          "the CPU, numpy's sequential filter {} vs the port's parallel one "
          "{} at T={}".format(ref_np, refs[KF_T_SHORT], KF_T_SHORT))
    ref_masked = kalman_loglik_np(y_masked, mask, system)
    walls, errs = {}, {}
    for T in (KF_T_SHORT, KF_T_LONG, KF_T_PAR):
        fwd = [run(par, on(T)) for _ in range(KF_PAR_ROUNDS)]
        both = [run(par, on(T, grad=True), grad=True)
                for _ in range(KF_PAR_ROUNDS)]
        errs["parallel", T] = max(ll_rel(o, refs[T], "parallel filter at "
                                         "T={}".format(T)) for o, _ in
                                  fwd + both)
        walls["parallel", T] = (float(np.median([w for _, w in fwd])),
                                float(np.median([w for _, w in both])))
    out, t_fwd = run(seq, on(KF_T_SHORT))
    out_b, t_both = run(seq, on(KF_T_SHORT, grad=True), grad=True)
    errs["sequential", KF_T_SHORT] = max(
        ll_rel(o, refs[KF_T_SHORT], "sequential filter at T={}".format(
            KF_T_SHORT)) for o in (out, out_b))
    walls["sequential", KF_T_SHORT] = (t_fwd, t_both)
    # the series and its masked copy (placeholders 1e6) in one batched run
    pair = on(KF_T_LONG, data=np.stack([y[:KF_T_LONG], y_masked]))
    pair_mask = torch.as_tensor(np.stack([np.ones(KF_T_LONG), mask]),
                                dtype=torch.float32, device=dev)
    out, t_pair = run(seq, pair, mask=pair_mask)
    errs["sequential", KF_T_LONG] = ll_rel(
        {"loglik": out["loglik"][0]}, refs[KF_T_LONG],
        "sequential filter at T={}".format(KF_T_LONG))
    err_masked = ll_rel({"loglik": out["loglik"][1]}, ref_masked,
                        "{:.0%}-masked sequential filter at T={}".format(
                            KF_MASK_SHARE, KF_T_LONG))
    walls["sequential", KF_T_LONG] = (t_pair, None)
    # the smoothers on the float32 filter's outputs (the unmasked series),
    # sequential against parallel
    A32 = torch.as_tensor(system[0], dtype=torch.float32, device=dev)
    smooth_args = tuple(out[k][0] for k in (
        "filtered_means", "filtered_covs", "pred_means", "pred_covs")) + \
        (A32,)
    (ms_seq, Ps_seq), t_sm_seq = run(
        lambda *a: kalman.rts_smoother(*a), smooth_args)
    (ms_par, Ps_par), t_sm_par = run(
        lambda *a: kalman.rts_smoother_parallel(*a), smooth_args)
    m_err = float((ms_seq - ms_par).abs().max() / ms_seq.abs().max())
    P_err = float((Ps_seq - Ps_par).abs().max() / Ps_seq.abs().max())
    check(m_err <= KF_SMOOTH_RTOL and P_err <= KF_SMOOTH_RTOL
          and bool(torch.isfinite(Ps_par).all()),
          "phase 46: smoothers at T={}, sequential vs parallel: means {} "
          "and covariances {} of their largest entry (tol {})".format(
              KF_T_LONG, m_err, P_err, KF_SMOOTH_RTOL))
    prof_seq = profile_window(lambda: seq(*on(KF_PROFILE_T)), ROOT / "build"
                              / "chip_smoke_kalman_seq_trace.json")
    prof_par = profile_window(lambda: par(*on(KF_T_PAR)), ROOT / "build"
                              / "chip_smoke_kalman_par_trace.json")
    check(read_counts() == none, "phase 46: launched {}".format(
        read_counts()))
    rows = []
    for (name, T), (f, b) in walls.items():
        rows.append("{} T={}: forward {:.3f} ms{}{}, rel {:.3e}".format(
            name, T, 1e3 * f, "" if b is None else
            ", forward+backward {:.3f} ms".format(1e3 * b),
            " ({:.4f} ms a step{})".format(
                1e3 * f / T, "" if b is None else
                ", {:.4f} with the backward".format(1e3 * b / T))
            if name == "sequential" else "", errs[name, T]))
    print("phase 46 kalman ({}): D={} E={}, float32 vs float64 on the CPU "
          "(tol {:.0e}), float64 {} | {} | the sequential run at T={} "
          "filters the series and its {:.0%}-masked copy (placeholders 1e6) "
          "as a batch of 2: masked rel {:.3e} | smoothers at T={}: "
          "sequential {:.3f} ms, parallel {:.3f} ms, means {:.3e} and "
          "covariances {:.3e} of their largest entry apart (tol {:.0e}) | "
          "no host sync in the sequential filter, its backward and the "
          "smoother; the parallel filter's sync warnings: {} | profile, "
          "sequential forward at T={}: {} | parallel forward at T={}: {} | "
          "wall {:.3f} s".format(
              card, KF_D, KF_E, KF_LL_RTOL,
              {T: round(v, 6) for T, v in refs.items()}, " | ".join(rows),
              KF_T_LONG, KF_MASK_SHARE, err_masked, KF_T_LONG,
              1e3 * t_sm_seq, 1e3 * t_sm_par, m_err, P_err, KF_SMOOTH_RTOL,
              len(par_syncs), KF_PROFILE_T, profile_summary(prof_seq, 1),
              KF_T_PAR, profile_summary(prof_par, 1),
              time.perf_counter() - t_phase), flush=True)

    # ---- 47. SSM MAP: the golden_ssm_map model at D = 4, E = 2
    t_phase = time.perf_counter()
    rows = []
    for label, T, parallel, steps in (
            ("parallel", SSM_PAR_T, True, SSM_PAR_STEPS),
            ("sequential", SSM_SEQ_T, False, SSM_SEQ_STEPS)):
        m = ssm_model(system, T, parallel)
        loop = recording_batch_loop(read_counts, sync)
        inf = GradBasedInference(MAP(model=m, observed=[m.y]),
                                 grad_loop=loop, dtype="float32", device=dev)
        zero_counts()
        inf.run(y=y[:T], max_iter=steps, learning_rate=SSM_LR,
                generator=gen(47))
        check(read_counts() == none, "phase 47 {}: launched {}".format(
            label, read_counts()))
        first64, _ = loss_and_grad_at(
            MAP(model=m, observed=[m.y]),
            {k: v.cpu() for k, v in loop.start_state.items()}, [y[:T]],
            "float64", "cpu", grad=False)
        first_rel = rel(loop.losses[0], first64)
        check(len(loop.losses) == steps and np.all(np.isfinite(loop.losses))
              and loop.losses[-1] < loop.losses[0]
              and first_rel <= KF_LL_RTOL, "phase 47 {}: losses {}, first "
              "loss vs float64 {}: relative {} (tol {})".format(
                  label, loop.losses, first64, first_rel, KF_LL_RTOL))
        rows.append("{} filter at T={}: {} Adam steps (lr {}), losses "
                    "{:.4f} -> {:.4f}, first loss vs float64 {:.4f}: rel "
                    "{:.3e}, step wall ms {}".format(
                        label, T, steps, SSM_LR, loop.losses[0],
                        loop.losses[-1], first64, first_rel,
                        wall_summary(loop.wall_s, listed=False)))
    print("phase 47 ssm MAP ({}): A ({}x{}) from 0.5·I | {} | no launch | "
          "wall {:.3f} s".format(card, KF_D, KF_D, " | ".join(rows),
                                 time.perf_counter() - t_phase), flush=True)

    # ---- 48. stochastic volatility by HMC
    t_phase = time.perf_counter()
    x_true, y_sv = sv_data(np.random.default_rng(seed + 48), SV_T)
    m = counting(sv_model(SV_T))
    infr = HMCInference(HMCAlgorithm(
        model=m, observed=[m.y], num_samples=SV_DRAWS, num_chains=SV_CHAINS,
        num_warmup=SV_WARMUP, num_leapfrog=SV_L), dtype="float32",
        device=dev)
    zero_counts()
    sync()
    t0 = time.perf_counter()
    xs = infr.run(y=y_sv, generator=gen(48))[m.x.uuid]
    sync()
    sv_s = time.perf_counter() - t0
    xs = xs.double().cpu().numpy()                   # (S, C, T)
    x_post = xs.mean(axis=(0, 1))
    lo, hi = np.percentile(xs, [5, 95], axis=(0, 1))
    corr = float(np.corrcoef(x_post, x_true)[0, 1])
    cover = float(((x_true >= lo) & (x_true <= hi)).mean())
    accept = infr.diagnostics["accept_rate"]
    check(xs.shape == (SV_DRAWS, SV_CHAINS, SV_T) and np.isfinite(xs).all()
          and corr > 0.5 and cover > 0.75 and read_counts() == none,
          "phase 48: draws {}, posterior mean's correlation with the true "
          "path {} (must exceed 0.5), 90% band coverage {} (must exceed "
          "0.75), launches {}".format(xs.shape, corr, cover, read_counts()))
    print("phase 48 stochastic volatility ({}): T={}, HMC {} chains, L={}, "
          "{} + {} transitions (cut from 500 + 500): {} potential "
          "evaluations in {:.3f} s, {:.1f} evaluations/s; accept rates {}, "
          "posterior mean's correlation with the true path {:.4f} (> 0.5), "
          "90% band coverage {:.4f} (> 0.75); no launch | wall {:.3f} s"
          .format(card, SV_T, SV_CHAINS, SV_L, SV_WARMUP, SV_DRAWS,
                  m.evaluations, sv_s, m.evaluations / sv_s,
                  [round(float(a), 3) for a in accept], corr, cover,
                  time.perf_counter() - t_phase), flush=True)

    # ---- 49. PILCO: K1 in every dynamics step and every rollout step
    t_phase = time.perf_counter()
    main_k1, lines = 0, []
    # (a) the example: s' = 0.9 s + 0.4 a
    rng = np.random.default_rng(seed + 49)
    S = rng.standard_normal((PILCO_EX_N, 1)) * 1.5
    U = rng.uniform(-1, 1, (PILCO_EX_N, 1))
    Y = 0.9 * S + 0.4 * U + rng.standard_normal((PILCO_EX_N, 1)) * 0.01
    for label, X_, Y_, dyn_steps, policy_steps, horizon, s0, lr in (
            ("example", np.concatenate([S, U], -1), Y, PILCO_EX_DYN,
             PILCO_EX_POLICY, PILCO_EX_H, np.ones((PILCO_EX_S, 1)), 0.1),
            ("wide",) + pilco_wide_data(rng) + (
                PILCO_DYN_STEPS, PILCO_POLICY_STEPS, PILCO_H,
                rng.standard_normal((PILCO_S, PILCO_DS)), PILCO_LR)):
        m = pilco_dynamics(X_.shape[1], Y_.shape[1])
        dyn_loop = recording_batch_loop(read_counts, sync)
        dyn = GradBasedInference(MAP(model=m, observed=[m.X, m.Y]),
                                 grad_loop=dyn_loop, dtype="float32",
                                 device=dev)
        zero_counts()
        dyn.run(max_iter=dyn_steps, learning_rate=0.05, X=X_, Y=Y_,
                generator=gen(49))
        dyn_counts = read_counts()
        check(dyn_counts == dict(none, K1=dyn_steps) and all(
            c == dict(none, K1=1) for c in dyn_loop.counts),
            "phase 49 {}: {} dynamics steps launched {}; expected K1 once a "
            "step".format(label, dyn_steps, dyn_counts))
        loop = recording_batch_loop(read_counts, sync)
        pinf = pilco_inference(m, dyn, horizon, s0, loop, dev)
        check_kernel = None
        if label == "wide":
            # K1 against its plain version over one rollout at the start
            pinf.initialize()
            ex = create_executor(pinf.inference_algorithm, pinf.params)
            w_uuid = m.policy_w.uuid

            def cost_and_grad():
                tr = {u: v.detach().clone().requires_grad_(u == w_uuid)
                      for u, v in pinf.params.trainable_params().items()}
                c = ex(tr, pinf.params.fixed_params(), [], gen(50))[0]
                g, = torch.autograd.grad(c, [tr[w_uuid]])
                sync()
                return float(c.detach()), g.double().cpu().numpy()

            zero_counts()
            c_k, g_k = cost_and_grad()
            k_launches = read_counts()["K1"]
            cuda_kernels.set_use_kernel(False)
            try:
                c_p, g_p = cost_and_grad()
            finally:
                cuda_kernels.set_use_kernel(True)
            check_kernel = (k_launches, read_counts()["K1"] - k_launches,
                            rel(c_k, c_p), rel_err(g_k, g_p))
            check(check_kernel[:2] == (horizon, 0)
                  and check_kernel[2] <= EXACT_F64_RTOL
                  and check_kernel[3] <= FAMILY_GRAD_RTOL,
                  "phase 49: one rollout, K1 vs plain: launches {} and {} "
                  "(expected {} and 0), cost relative {} (tol {}), policy "
                  "gradient {} of its largest entry (tol {})".format(
                      check_kernel[0], check_kernel[1], horizon,
                      check_kernel[2], EXACT_F64_RTOL, check_kernel[3],
                      FAMILY_GRAD_RTOL))
        zero_counts()
        pinf.run(max_iter=policy_steps, learning_rate=lr, generator=gen(51))
        policy_counts = read_counts()
        check(policy_counts == dict(none, K1=policy_steps * horizon)
              and all(c == dict(none, K1=horizon) for c in loop.counts),
              "phase 49 {}: {} policy steps launched {}; expected K1 once a "
              "rollout step, {} a policy step".format(
                  label, policy_steps, policy_counts, horizon))
        main_k1 += dyn_counts["K1"] + policy_counts["K1"]
        w = pinf.params[m.policy_w].double().cpu().numpy().ravel()
        check(np.all(np.isfinite(loop.losses)) and np.isfinite(w).all(),
              "phase 49 {}: losses {}, policy weight {}".format(
                  label, loop.losses, w))
        if label == "example":
            check(loop.losses[-1] < loop.losses[0] and w[0] < 0.0,
                  "phase 49: the example's cost {} -> {} must fall and its "
                  "gain {} be negative".format(loop.losses[0],
                                               loop.losses[-1], w[0]))
        ck = check_kernel
        lines.append(
            "{}: X {} Y {}, dynamics {} MAP steps (K1 1 a step, step wall "
            "ms {}), policy {} steps of horizon {} over {} samples (K1 {} a "
            "step, step wall ms {}), cost {:.5g} -> {:.5g}, gain {}{}"
            .format(label, X_.shape, Y_.shape, dyn_steps,
                    wall_summary(dyn_loop.wall_s, listed=False),
                    policy_steps, horizon, s0.shape[0], horizon,
                    wall_summary(loop.wall_s, listed=False), loop.losses[0],
                    loop.losses[-1], np.round(w, 4).tolist(),
                    "" if ck is None else "; one rollout K1 vs plain: "
                    "launches {} / {}, cost rel {:.3e} (tol {:.0e}), policy "
                    "gradient {:.3e} of its largest entry (tol {:.0e})"
                    .format(ck[0], ck[1], ck[2], EXACT_F64_RTOL, ck[3],
                            FAMILY_GRAD_RTOL)))
        if label == "wide":
            prof = profile_window(
                lambda: pinf.run(max_iter=2, learning_rate=lr,
                                 generator=gen(52)),
                ROOT / "build" / "chip_smoke_pilco_trace.json")
            lines.append("profile of 2 wide policy steps: "
                         + profile_summary(prof, 2))
    print("phase 49 pilco ({}): {} | K1 on the main paths {} | wall {:.3f} "
          "s".format(card, " | ".join(lines), main_k1,
                     time.perf_counter() - t_phase), flush=True)
    return main_k1


def pilco_wide_data(rng):
    """Phase 49's wider configuration: N transitions of a damped 4-state,
    1-action linear system s' = F s + g a (F = 0.9·I plus 0.05 N(0, 1)
    entries), random actions: (X (N, 5), Y (N, 4))."""
    F = 0.9 * np.eye(PILCO_DS) + 0.05 * rng.standard_normal(
        (PILCO_DS, PILCO_DS))
    g = 0.5 * rng.standard_normal((PILCO_DS, 1))
    S = rng.standard_normal((PILCO_N, PILCO_DS))
    U = rng.uniform(-1, 1, (PILCO_N, 1))
    Y = S @ F.T + U @ g.T + 0.01 * rng.standard_normal((PILCO_N, PILCO_DS))
    return np.concatenate([S, U], -1), Y


def splitmix_shuffle(n, seed):
    """The plain version of ``fast_batcher.cpp``'s ``shuffled_indices``:
    the splitmix64 Fisher-Yates in pure Python."""
    mask, gamma = (1 << 64) - 1, 0x9E3779B97F4A7C15
    idx = list(range(n))
    x = (seed + gamma) & mask
    for i in range(n - 1, 0, -1):
        x = (x + gamma) & mask
        z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        j = (z ^ (z >> 31)) % (i + 1)
        idx[i], idx[j] = idx[j], idx[i]
    return np.asarray(idx)


def north_star_data(seed):
    """benchmarks/svgp_1m.py:38-48's data and inducing start (10^6 rows,
    d = 8, M = 256), from its generator."""
    rng = np.random.default_rng(seed)
    X = rng.random((NGD_N, NGD_D)).astype(np.float32) * 4
    f = np.sin(X[:, :1] * 2.0) + 0.3 * np.cos(X[:, 1:2] * 3.0)
    Y = (f + rng.standard_normal((NGD_N, 1)).astype(np.float32) * 0.1
         ).astype(np.float32)
    return X, Y, rng.random((NGD_M, NGD_D)) * 4


def north_star_model(Z0):
    """benchmarks/svgp_1m.py:41-48's SVGP: RBF(d) at variance and
    lengthscale 1, noise 0.5, fresh UUIDs at every call."""
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.modules import SVGPRegression
    m, alg = gp_model(SVGPRegression, RBF(input_dim=NGD_D, variance=1.0,
                                           lengthscale=1.0), NGD_D,
                      noise=0.5, inducing_inputs=_variable(
                          shape=(NGD_M, NGD_D), initial_value=Z0))
    return m, alg


def _variable(**kw):
    from mxfusion_tpu_torch import Variable
    return Variable(**kw)


def traced_idle(fn, log_dir):
    """``fn()`` inside ``util.profiling.trace`` and one ``annotate``d
    range, the device synchronized before the range closes: the idle
    share of that range from the trace the module wrote."""
    import torch
    from mxfusion_tpu_torch.util.profiling import annotate, trace
    with trace(str(log_dir)):
        with annotate("chip_smoke_epoch"):
            fn()
            torch.cuda.synchronize()
    path = sorted(Path(log_dir).glob("trace_*.json"),
                  key=lambda p: p.stat().st_mtime)[-1]
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    (mark,) = [e for e in events if e.get("name") == "chip_smoke_epoch"
               and e.get("cat") == "user_annotation"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(device, "util.profiling.trace recorded no device event")
    return device_busy(device, mark["ts"], mark["ts"] + mark["dur"])


def model_axis_part(dev, card, seed, tm, start_state, Xtr, Ytr,
                    read_counts, zero_counts, sync):
    """Phase 53's model axis over the world of one: ``make_mesh_2d(1, 1)``
    with q(U)'s three parameters and Z placed over ``model`` by
    ``device_put``, MA_STEPS ``make_shard_map_step`` Adam steps at the
    headline shape (phase 6's model, start and first batch, the fused
    arm) against the replicated step from the same state, in the order
    replicated, placed, placed, replicated; then one step each way at
    benchmarks/model_axis_2d.py's widths and the bytes this rank holds
    for the placed parameters and their Adam moments. Returns the line's
    text and K1-K3's launches."""
    import torch
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.common.placement import is_sharded
    from mxfusion_tpu_torch.components.distributions.gp.kernels import RBF
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    from mxfusion_tpu_torch.inference import (MAP, GradBasedInference,
                                              create_executor)
    from mxfusion_tpu_torch.modules import SVGPRegression
    from mxfusion_tpu_torch.parallel import (
        batch_sharding, device_put, make_mesh_2d, make_shard_map_step,
        shard_data)
    t_part = time.perf_counter()
    mesh2 = make_mesh_2d(1, 1)
    launches = {"K1": 0, "K2": 0, "K3": 0}

    def placed_uuids(m):
        q = m.Y.factor._extra_graphs[0]
        return {q.qU_mean.uuid, q.qU_cov_W.uuid, q.qU_cov_diag.uuid,
                m.Y.factor._module_graph.inducing_inputs.uuid}

    def run(m, ex, state, trainable, data, steps, placed):
        """``steps`` shard_map steps from ``state`` (its ``trainable``
        entries trained): losses, walls, per-step launches and the bytes
        held of the placed entries and their moments."""
        uuids = placed_uuids(m)
        step, opt = make_shard_map_step(ex, mesh2, "adam", MA_LR)
        tr = {k: v.clone() for k, v in state.items() if k in trainable}
        if placed:
            tr = {k: device_put(v, batch_sharding(mesh2, v.ndim, "model"))
                  if k in uuids else v for k, v in tr.items()}
        fx = {k: v for k, v in state.items() if k not in trainable}
        opt_state = opt.init(tr)
        losses, walls, counts = [], [], []
        for _ in range(steps):
            zero_counts()
            sync()
            t0 = time.perf_counter()
            tr, opt_state, loss, _ = step(
                tr, fx, opt_state, torch.Generator(dev).manual_seed(seed),
                data)
            losses.append(float(loss))
            sync()
            walls.append(time.perf_counter() - t0)
            counts.append({k: read_counts()[k] for k in launches})
            for k in launches:
                launches[k] += counts[-1][k]
        check(all(is_sharded(tr[k]) == placed for k in uuids),
              "the step handed back the placed parameters as {}".format(
                  {k: type(tr[k]).__name__ for k in uuids}))
        held = sum(t.numel() * t.element_size() for k in uuids
                   for t in (opt_state.leaves[k],
                             opt_state.state[opt_state.leaves[k]]["exp_avg"],
                             opt_state.state[opt_state.leaves[k]][
                                 "exp_avg_sq"]))
        return losses, walls, counts, held

    # the headline shape: phase 6's model, start and first batch
    alg = MAP(model=tm, observed=[tm.X, tm.Y])
    inf = GradBasedInference(alg, dtype="float32", device=dev)
    inf.initialize(X=Xtr[:TRAIN_B], Y=Ytr[:TRAIN_B])
    inf.params.update_params({k: v.clone() for k, v in start_state.items()})
    trainable = set(inf.params.trainable_params())
    ex = create_executor(alg, inf.params,
                         rv_scaling={tm.Y.uuid: TRAIN_N / TRAIN_B})
    data = shard_data(mesh2, [Xtr[:TRAIN_B], Ytr[:TRAIN_B]])
    runs = {"replicated": [], "placed": []}
    for which in ("replicated", "placed", "placed", "replicated"):
        runs[which].append(run(tm, ex, start_state, trainable, data,
                               MA_STEPS, which == "placed"))
    per_step = {"K1": 1, "K2": 1, "K3": 3}
    for which, rs in runs.items():
        for losses, _, counts, _ in rs:
            check(len(losses) == MA_STEPS and all(
                math.isfinite(x) for x in losses), "{} model-axis losses {}"
                .format(which, losses))
            check(all(c == per_step for c in counts), "{} model-axis step "
                  "launched {}; expected {} a step".format(
                      which, counts, per_step))
    ref = runs["replicated"][0][0]
    rel = max(abs(a - b) / abs(b) for r in runs["placed"] + runs[
        "replicated"][1:] for a, b in zip(r[0], ref))
    check(rel <= MA_RTOL, "placed over the model axis: losses {} vs the "
          "replicated step's {}: rel {}".format(
              [r[0] for r in runs["placed"]], ref, rel))
    bitwise = all(r[0] == ref for r in runs["placed"])
    # each run's first step also builds the optimizer's state (and the
    # first placed one NCCL's communicator of the model axis)
    walls = {k: "median {:.3f} (quartiles {:.3f}-{:.3f}) of {}, first "
             "steps {}".format(
                 *np.percentile([1e3 * w for r in rs for w in r[1][1:]],
                                [50, 25, 75]),
                 sum(len(r[1]) - 1 for r in rs),
                 [round(1e3 * r[1][0], 3) for r in rs])
             for k, rs in runs.items()}

    # benchmarks/model_axis_2d.py's widths: one step each way
    rng = np.random.default_rng(seed + 530)
    Xm = (rng.random((MA_B, MA_D)) * BOX).astype(np.float32)
    Ym = (np.sin(Xm[:, :1]) + rng.standard_normal((MA_B, 1)) * 0.1
          ).astype(np.float32)
    mm = Model()
    mm.n = Variable()
    mm.X = Variable(shape=(mm.n, MA_D))
    mm.noise_var = Variable(transformation=PositiveTransformation(),
                            initial_value=0.1)
    mm.Y = SVGPRegression.define_variable(
        X=mm.X, kernel=RBF(input_dim=MA_D, variance=1.0,
                           lengthscale=math.sqrt(MA_D)),
        noise_var=mm.noise_var, shape=(mm.n, 1),
        inducing_inputs=Variable(shape=(MA_M, MA_D), initial_value=(
            rng.random((MA_M, MA_D)) * BOX).astype(np.float32)))
    malg = MAP(model=mm, observed=[mm.X, mm.Y])
    minf = GradBasedInference(malg, dtype="float32", device=dev)
    minf.initialize(X=Xm, Y=Ym, generator=torch.Generator(dev).manual_seed(
        seed))
    mstate = {k: v.clone() for k, v in minf.params.param_dict.items()}
    trainable = set(minf.params.trainable_params())
    mex = create_executor(malg, minf.params)
    mdata = shard_data(mesh2, [Xm, Ym])
    wide = {which: run(mm, mex, mstate, trainable, mdata, 1,
                       which == "placed")
            for which in ("replicated", "placed")}
    wrel = abs(wide["placed"][0][0] - wide["replicated"][0][0]) / abs(
        wide["replicated"][0][0])
    check(wrel <= MA_RTOL and wide["placed"][2] == wide["replicated"][2],
          "M={}: placed step loss {} launches {} vs replicated {} {}".format(
              MA_M, wide["placed"][0], wide["placed"][2],
              wide["replicated"][0], wide["replicated"][2]))
    arithmetic = 12 * (MA_M * MA_M + 2 * MA_M + MA_M * MA_D)
    check(wide["placed"][3] == arithmetic, "M={}: this rank holds {} bytes "
          "of q(U), Z and their Adam moments; 12·(M² + 2M + M·D) = {}"
          .format(MA_M, wide["placed"][3], arithmetic))
    line = (
        "model axis ({}): make_mesh_2d(1, 1), qU_mean, qU_cov_W, "
        "qU_cov_diag and Z placed over 'model' by device_put, {} "
        "make_shard_map_step Adam steps (lr {}) at B={}, M={}, D={} from "
        "phase 6's start, fused arm: losses {} vs replicated {}, max rel "
        "{:.3e} (tol {:.0e}), bit-equal {}, launches a step {} | step wall "
        "ms after each run's first step: placed {}, replicated {} | M={}, "
        "D={}, B={}: one step each way, loss rel {:.3e}, launches {}, "
        "bytes this rank holds of q(U), Z and Adam's two moments {} "
        "({:.1f} MB; on a model axis of one rank, the whole) | part wall "
        "{:.3f} s".format(
            card, MA_STEPS, MA_LR, TRAIN_B, M, D,
            runs["placed"][0][0], ref, rel, MA_RTOL, bitwise,
            runs["placed"][0][2][0],
            walls["placed"], walls["replicated"],
            MA_M, MA_D, MA_B, wrel, wide["placed"][2][0],
            wide["placed"][3], wide["placed"][3] / 1e6,
            time.perf_counter() - t_part))
    return line, launches


def loop_options_phases(dev, card, seed, Xtr, Ytr, x_ppca, W0, read_counts,
                        zero_counts, sync, tm, start_state):
    """Phases 50-53: the native batcher, the north star's host loop at
    batches_per_call 1, 5 and 20, remat, and data parallelism over a
    world of one (NCCL). Returns K1-K3's launches on their main paths."""
    import torch
    import torch.distributed as dist
    from mxfusion_tpu_torch.inference import (
        MAP, BatchInferenceLoop, BatchedPredictor, GradBasedInference,
        HMCAlgorithm, Inference, MinibatchInferenceLoop,
        StochasticVariationalInference, create_executor,
        create_sampling_executor)
    from mxfusion_tpu_torch.native import (gather_rows, native_available,
                                           shuffled_indices)
    from mxfusion_tpu_torch.parallel import (
        DataParallelBatchLoop, DataParallelMinibatchLoop, data_shardings,
        initialize_distributed, make_mesh, shard_data)
    launches = {"K1": 0, "K2": 0, "K3": 0}

    def add_launches():
        for k in launches:
            launches[k] += read_counts()[k]

    # ---- 50. the native batcher on the card's host
    t_phase = time.perf_counter()
    check(native_available(), "the native batcher did not build on this "
          "host: the loops would shuffle by numpy, unlike JAX's")
    X, Y, Z0 = north_star_data(seed)
    perms = []
    for e in range(3):
        p = shuffled_indices(NGD_N, seed=e)
        check(np.array_equal(np.sort(p), np.arange(NGD_N)),
              "shuffled_indices({}, {}) is not a permutation".format(NGD_N, e))
        perms.append(p)
    check(not np.array_equal(perms[0], perms[1]), "epochs 0 and 1 shuffle "
          "alike")
    small = [np.array_equal(shuffled_indices(SPLITMIX_N, e),
                            splitmix_shuffle(SPLITMIX_N, e)) for e in range(3)]
    check(all(small), "shuffled_indices at N={} differs from the plain "
          "splitmix64 Fisher-Yates: {}".format(SPLITMIX_N, small))
    table = np.concatenate([X, Y], axis=1)
    idx = perms[0][:NGD_B * 20]
    t0 = time.perf_counter()
    got = gather_rows(table, idx)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = table[idx]
    numpy_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(got, want), "gather_rows differs from numpy "
          "indexing on the ({}, {}) table".format(*table.shape))
    print("phase 50 native batcher ({}): native_available True | "
          "shuffled_indices(10^6, e) a permutation for e = 0, 1, 2 | equal "
          "to the plain splitmix64 Fisher-Yates at N={} for e = 0, 1, 2 | "
          "gather_rows of {} rows x {} columns equal to numpy indexing: "
          "{:.3f} ms native, {:.3f} ms numpy | wall {:.3f} s".format(
              card, SPLITMIX_N, idx.size, table.shape[1], native_ms,
              numpy_ms, time.perf_counter() - t_phase), flush=True)
    del table, got, want

    # ---- 51. the north star's host path: one epoch at k = 1, 5, 20
    t_phase = time.perf_counter()
    nm, nalg = north_star_model(Z0)
    start_inf = GradBasedInference(nalg, dtype="float32", device=dev)
    start_inf.initialize(X=X[:NGD_B], Y=Y[:NGD_B],
                         generator=torch.Generator(dev).manual_seed(seed))
    nstart = {k: v.clone() for k, v in start_inf.params.param_dict.items()}

    def north_star_epoch(loop, traced=None):
        inf = GradBasedInference(nalg, grad_loop=loop, dtype="float32",
                                 device=dev)
        inf.params.update_params({k: v.clone() for k, v in nstart.items()})
        losses = []
        zero_counts()
        sync()
        t0 = time.perf_counter()

        def run():
            inf.run(X=X, Y=Y, max_iter=1, learning_rate=NGD_LR,
                    generator=torch.Generator(dev).manual_seed(seed),
                    callback=lambda e, l: losses.append(l))
        idle = traced_idle(run, traced) if traced else run()
        sync()
        wall = time.perf_counter() - t0
        counts = read_counts()
        add_launches()
        return inf, losses[0], wall, counts, idle

    runs, walls = {}, {1: [], 5: [], 20: []}
    # in turns, so that no k alone pays the first use of pinned memory
    for k in (1, 5, 20, 20, 5, 1):
        loop = MinibatchInferenceLoop(batch_size=NGD_B,
                                      rv_scaling={nm.Y: NGD_N / NGD_B},
                                      batches_per_call=k)
        inf, loss, wall, counts, _ = north_star_epoch(loop)
        walls[k].append(wall)
        if k in runs:
            check(loss == runs[k][1], "k={}: a second epoch from the same "
                  "start gave {} against {}".format(k, loss, runs[k][1]))
            continue
        steps = -(-(-(-NGD_N // NGD_B)) // k) * k
        check(counts == {"K1": steps, "K2": steps, "K3": 3 * steps,
                         "K4": 0, "K5": 0},
              "k={}: launches {} for {} steps; expected K1 1, K2 1, K3 3 "
              "a step".format(k, counts, steps))
        check(loop.h2d_copies == steps // k, "k={}: {} host-to-device "
              "copies, expected one a call ({})".format(
                  k, loop.h2d_copies, steps // k))
        check(math.isfinite(loss), "k={}: epoch loss {}".format(k, loss))
        runs[k] = (inf, loss, wall, counts, steps, loop.h2d_copies)
    rel5 = abs(runs[5][1] - runs[1][1]) / abs(runs[1][1])
    check(rel5 <= NS_K5_RTOL, "k=5's epoch loss {} vs k=1's {}: rel {}"
          .format(runs[5][1], runs[1][1], rel5))
    _, _, traced_wall, _, idle = north_star_epoch(
        MinibatchInferenceLoop(batch_size=NGD_B,
                               rv_scaling={nm.Y: NGD_N / NGD_B},
                               batches_per_call=20),
        traced=ROOT / "build" / "chip_smoke_loop_trace")
    wall_ms, busy_ms, by_name = idle
    print("phase 51 north star host path ({}): benchmarks/svgp_1m.py's "
          "N={}, d={}, M={}, B={}, MAP + Adam (lr {}), one epoch from one "
          "start each | {} | k=5 vs k=1 epoch loss rel {:.3e} (tol {:.0e}) "
          "| one k=20 epoch under util.profiling.trace: wall {:.3f} s, "
          "device busy {:.3f} ms of {:.3f}, idle share {:.1%}, top kernels "
          "{} | wall {:.3f} s".format(
              card, NGD_N, NGD_D, NGD_M, NGD_B, NGD_LR, " | ".join(
                  "k={}: {} steps, epoch loss {:.8g}, epoch walls {} s "
                  "({:.3f} ms a step at the faster), {} H2D copies, "
                  "launches K1 {} K2 {} K3 {}".format(
                      k, r[4], r[1], [round(w, 3) for w in walls[k]],
                      min(walls[k]) / r[4] * 1e3, r[5], r[3]["K1"],
                      r[3]["K2"], r[3]["K3"])
                  for k, r in runs.items()),
              rel5, NS_K5_RTOL, traced_wall, busy_ms, wall_ms,
              1 - busy_ms / wall_ms, " | ".join(
                  "{} {:.3f} ms".format(n, v / 1e3) for n, v in by_name[:4]),
              time.perf_counter() - t_phase), flush=True)

    # ---- 52. remat: one step with and without, same state, batch and
    # generator seed, at the headline SVGP step and a sampled objective
    t_phase = time.perf_counter()
    hm = headline_svgp(np.random.default_rng(seed + 52).uniform(
        0.0, BOX, (M, D)))
    halg = MAP(model=hm, observed=[hm.X, hm.Y])
    hinf = GradBasedInference(halg, dtype="float32", device=dev)
    hdata = [Xtr[:TRAIN_B], Ytr[:TRAIN_B]]
    hinf.initialize(X=hdata[0], Y=hdata[1],
                    generator=torch.Generator(dev).manual_seed(seed))
    mf_build = lambda dtype: meanfield_ppca(  # noqa: E731
        x_ppca.shape[0], W0.shape[0], x_ppca.shape[1], W0, dtype)
    mf = meanfield_inference(mf_build, StochasticVariationalInference,
                             MF_S, dev)
    mf.initialize(x=x_ppca, generator=torch.Generator(dev).manual_seed(seed))
    lines = []
    for label, inf, data in (
            ("headline SVGP (B={}, M={}, D={})".format(TRAIN_B, M, D),
             hinf, hdata),
            ("mean-field PPCA SVI (phase 18, S={})".format(MF_S), mf,
             [x_ppca])):
        out = {}
        for remat in (False, True):
            ex = create_executor(inf.inference_algorithm, inf.params,
                                 remat=remat)
            leaves = {k: v.detach().clone().requires_grad_(True)
                      for k, v in inf.params.trainable_params().items()}
            tensors = [torch.as_tensor(d, device=dev) for d in data]
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            zero_counts()
            g = torch.Generator(dev).manual_seed(seed + 52)
            loss, lfg, _ = ex(leaves, inf.params.fixed_params(), tensors, g)
            lfg.backward()
            sync()
            peak = torch.cuda.max_memory_allocated(dev) - base
            counts = read_counts()
            add_launches()
            out[remat] = (float(loss.detach()),
                          {k: v.grad for k, v in leaves.items()
                           if v.grad is not None}, peak, counts,
                          g.get_state())
        (l0, g0, p0, c0, s0), (l1, g1, p1, c1, s1) = out[False], out[True]
        check(l0 == l1, "{}: remat loss {} vs {}".format(label, l1, l0))
        check(torch.equal(s0, s1), "{}: the generator ends elsewhere "
              "under remat".format(label))
        worst, bitwise = 0.0, True
        for k, a in g0.items():
            b = g1[k]
            scale = float(a.abs().max()) or 1.0
            worst = max(worst, float((a - b).abs().max()) / scale)
            bitwise = bitwise and torch.equal(a, b)
        check(worst <= REMAT_GRAD_TOL, "{}: remat gradients {} of the "
              "largest entry off".format(label, worst))
        check(c1["K2"] == 2 * c0["K2"], "{}: K2 {} under remat against {}"
              .format(label, c1["K2"], c0["K2"]))
        lines.append(
            "{}: loss {:.8g} both ways, gradients {:.3e} of the largest "
            "entry apart (tol {:.0e}), bit-equal {} | peak memory above "
            "the inputs {:.1f} MiB plain, {:.1f} MiB remat | launches "
            "plain {} remat {}".format(
                label, l0, worst, REMAT_GRAD_TOL, bitwise, p0 / 2 ** 20,
                p1 / 2 ** 20, c0, c1))
    print("phase 52 remat ({}): one step each way at one state, batch and "
          "generator seed | {} | wall {:.3f} s".format(
              card, " | ".join(lines), time.perf_counter() - t_phase),
          flush=True)
    del hinf, mf

    # ---- 53. data parallel over a world of one on the card (NCCL)
    t_phase = time.perf_counter()
    initialize_distributed(num_processes=1)   # one process: a no-op
    mesh = make_mesh()
    backend = dist.get_backend()
    check("nccl" in str(backend), "the world of one has backend {}, not "
          "NCCL".format(backend))
    # NCCL makes its communicator at the first collective: time that
    # apart, not inside the first loop's epoch
    ones = torch.ones(8, device=dev)
    sync()
    t0 = time.perf_counter()
    dist.all_reduce(ones)
    sync()
    nccl_init_s = time.perf_counter() - t0
    check(float(ones.sum()) == 8.0, "all_reduce over a world of one "
          "changed its input: {}".format(ones))
    # DataParallelMinibatchLoop at phase 51's configuration, k = 5
    dloop = DataParallelMinibatchLoop(mesh, batch_size=NGD_B,
                                      rv_scaling={nm.Y: NGD_N / NGD_B},
                                      batches_per_call=5)
    dinf, dloss, dwall, dcounts, _ = north_star_epoch(dloop)
    drel = abs(dloss - runs[5][1]) / abs(runs[5][1])
    check(drel <= DP_RTOL, "DataParallelMinibatchLoop's epoch loss {} vs "
          "phase 51's k=5 {}: rel {}".format(dloss, runs[5][1], drel))
    dp_lines = ["DataParallelMinibatchLoop(k=5): epoch loss {:.8g} vs "
                "{:.8g}, rel {:.3e} (tol {:.0e}), epoch wall {:.3f} s vs "
                "{} s, launches {}".format(
                    dloss, runs[5][1], drel, DP_RTOL, dwall,
                    [round(w, 3) for w in walls[5]], dcounts)]
    # DataParallelBatchLoop on BASELINE config 5 (phases 37-38's widths)
    for label, build, data, S, lr in (
            ("BNN", lambda dtype, d: bnn_model(dtype, d, seed + 37),
             {"x": None, "y": None}, BNN_S, BNN_LR),
            ("VAE", lambda dtype, d: vae_model(dtype, d, seed + 38),
             {"x": None}, VAE_S, VAE_LR)):
        rng = np.random.default_rng(seed + 53)
        if label == "BNN":
            xb = (rng.random((BNN_N, BNN_IN)) * 2 - 1).astype(np.float32)
            data = {"x": xb, "y": (np.sin(3 * xb[:, :1]) + rng.standard_normal(
                (BNN_N, 1)) * 0.05).astype(np.float32)}
        else:
            zt = rng.standard_normal((VAE_N, VAE_K))
            data = {"x": (np.tanh(zt @ rng.standard_normal((VAE_K, VAE_D)))
                          + rng.standard_normal((VAE_N, VAE_D)) * 0.05
                          ).astype(np.float32)}
        res = {}
        for tag, loop in (("single", BatchInferenceLoop()),
                          ("dp", DataParallelBatchLoop(mesh))):
            inf = nn_inference(build, S, dev, grad_loop=loop)
            losses, walls = [], []
            t_last = [None]

            def cb(i, l):
                sync()
                now = time.perf_counter()
                if t_last[0] is not None:
                    walls.append(now - t_last[0])
                t_last[0] = now
                losses.append(float(l))
            zero_counts()
            inf.run(max_iter=DP_NN_STEPS, learning_rate=lr,
                    generator=torch.Generator(dev).manual_seed(seed),
                    callback=cb, **data)
            check(read_counts()["K1"] == 0, "{}: launched {}".format(
                label, read_counts()))
            res[tag] = (losses, walls)
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["dp"][0],
                                                      res["single"][0]))
        check(len(res["dp"][0]) == DP_NN_STEPS and rel <= DP_NN_RTOL,
              "{}: DataParallelBatchLoop's losses {} vs {}: rel {}".format(
                  label, res["dp"][0], res["single"][0], rel))
        dp_lines.append(
            "DataParallelBatchLoop {} ({} steps): losses rel {:.3e} (tol "
            "{:.0e}), step wall ms {} vs single {}".format(
                label, DP_NN_STEPS, rel, DP_NN_RTOL,
                wall_summary(res["dp"][1], listed=False),
                wall_summary(res["single"][1], listed=False)))
    # BatchedPredictor(mesh=) on 262144 rows against the plain predictor
    bulk = X[:DP_SERVE_ROWS]
    outs = {}
    for tag, kw in (("plain", {}), ("mesh", {"mesh": mesh})):
        pred = BatchedPredictor(model=nm, infr_params=runs[5][0].params,
                                observed=[nm.X], target_variables=[nm.Y.uuid],
                                chunk_size=CHUNK, **kw)
        pred.predict(X=bulk[:CHUNK])
        zero_counts()
        sync()
        t0 = time.perf_counter()
        outs[tag] = pred.predict(X=bulk)[0]
        sync()
        outs[tag + "_s"] = time.perf_counter() - t0
        outs[tag + "_k1"] = read_counts()["K1"]
        add_launches()
    serr = max(float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))
               for a, b in zip(outs["mesh"], outs["plain"]))
    check(serr <= DP_SERVE_TOL, "mesh serving vs plain: {} of the largest "
          "entry".format(serr))
    dp_lines.append(
        "BatchedPredictor(mesh=) on {} rows: {:.3e} of the largest entry "
        "from the plain predictor, {:.1f} vs {:.1f} rows/s, K1 {} and {}"
        .format(DP_SERVE_ROWS, serr, DP_SERVE_ROWS / outs["mesh_s"],
                DP_SERVE_ROWS / outs["plain_s"], outs["mesh_k1"],
                outs["plain_k1"]))
    # HMC on phase 39's BLR over shard_data against the unsharded chain
    Xb, yb = blr_data(np.random.default_rng(seed), MCMC_N, MCMC_D)
    chains = {}
    for tag in ("plain", "sharded"):
        m = blr_model(MCMC_N, MCMC_D, MCMC_S2, symbolic=True)
        alg = HMCAlgorithm(model=m, observed=[m.X, m.y],
                           num_samples=DP_HMC_DRAWS, num_warmup=DP_HMC_DRAWS,
                           num_chains=MCMC_CHAINS, num_leapfrog=MCMC_L,
                           step_size=MCMC_EPS0)
        inf = Inference(inference_algorithm=alg, dtype="float32", device=dev)
        inf.initialize(X=Xb, y=yb)
        if tag == "plain":
            ex = create_sampling_executor(alg, inf.params)
            data = [torch.as_tensor(Xb, device=dev),
                    torch.as_tensor(yb, device=dev)]
        else:
            ex = create_sampling_executor(
                alg, inf.params, data_sharding=data_shardings(mesh, [Xb, yb]))
            data = shard_data(mesh, [Xb, yb])
        sync()
        t0 = time.perf_counter()
        samples, _ = ex(inf.params.trainable_params(),
                        inf.params.fixed_params(), data,
                        torch.Generator(dev).manual_seed(seed + 53))
        sync()
        chains[tag] = (samples[m.w.uuid].double().cpu().numpy(),
                       time.perf_counter() - t0)
    herr = float(np.abs(chains["sharded"][0] - chains["plain"][0]).max())
    check(herr <= DP_HMC_ATOL, "HMC over shard_data vs the unsharded chain: "
          "max |diff| {}".format(herr))
    dp_lines.append(
        "HMC on the BLR (N={}, D={}, {} chains, {} + {} transitions, L={}) "
        "over shard_data: max |draw diff| {:.3e} (tol {:.0e}), {:.3f} s vs "
        "{:.3f} s".format(MCMC_N, MCMC_D, MCMC_CHAINS, DP_HMC_DRAWS,
                          DP_HMC_DRAWS, MCMC_L, herr, DP_HMC_ATOL,
                          chains["sharded"][1], chains["plain"][1]))
    ma_line, ma_launches = model_axis_part(
        dev, card, seed, tm, start_state, Xtr, Ytr, read_counts, zero_counts,
        sync)
    for k in launches:
        launches[k] += ma_launches[k]
    dp_lines.append(ma_line)
    dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived phase 53")
    print("phase 53 data parallel ({}): a world of one, backend {}, the "
          "first all_reduce (NCCL's communicator) {:.3f} s; NCCL refuses two "
          "ranks on one GPU, so multi-rank equality is the CPU tests' | {} | "
          "wall {:.3f} s".format(
              card, backend, nccl_init_s, " | ".join(dp_lines),
              time.perf_counter() - t_phase), flush=True)
    return launches


SERVE_DRAWS = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, {root!r})
from mxfusion_tpu_torch.inference import load_exported_predictor
from mxfusion_tpu_torch.ops import keyed_random

t0 = time.perf_counter()
served = load_exported_predictor({artifact!r})
load_s = time.perf_counter() - t0
X = np.load({request!r})
served.predict(X=X[:{chunk}])
torch.cuda.synchronize()
out, walls, launches = {{}}, [], []
for seed in (1, 2):
    g = torch.Generator("cuda").manual_seed(seed)
    keyed_random.keyed_standard_gamma.launches = 0
    keyed_random.keyed_poisson.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["y{{}}".format(seed)] = served.predict(X=X, generator=g)[0]
    walls.append(time.perf_counter() - t0)
    launches.append([keyed_random.keyed_standard_gamma.launches,
                     keyed_random.keyed_poisson.launches])
    out["state{{}}".format(seed)] = g.get_state().numpy()
np.savez({out!r}, **out)
nodes = sorted(str(n.target) for n in served._program.graph.nodes
               if "keyed_" in str(n.target))
held = [k for k in sys.modules if k.split(".")[0] in
        ("jax", "jaxlib", "mxfusion_tpu", "chip_smoke")
        and sys.modules[k] is not None]
print(json.dumps({{"load_s": load_s, "walls": walls, "launches": launches,
                  "nodes": nodes, "held": held}}))
"""


def student_t_rand_gen():
    """tests/test_torch_export.py's heavy-tailed propagation: each normal
    draw n becomes n·sqrt(a / g), g ~ Gamma(a), a = STUDENT_T_SHAPE."""
    import torch
    from mxfusion_tpu_torch.components.distributions.random_gen import \
        RandomGenerator

    class StudentTPropagation(RandomGenerator):
        def sample_normal(self, generator, loc=0.0, scale=1.0, shape=None,
                          dtype=None):
            n = super().sample_normal(generator, shape=shape, dtype=dtype)
            g = self.sample_gamma(generator, alpha=STUDENT_T_SHAPE,
                                  shape=shape, dtype=dtype)
            return loc + scale * n * torch.sqrt(STUDENT_T_SHAPE / g)
    return StudentTPropagation()


def count_model(dev, seed):
    """Phase 58's count predictor's model: X (n, D) -> Linear(D, 64) ->
    tanh -> Linear(64, 1) -> softplus -> ``mu``, the mean of a
    ``NegativeBinomial`` whose dispersion is learned from NB_DISPERSION.
    The network's weights come from ``torch.manual_seed(seed)``."""
    import torch
    from mxfusion_tpu_torch import Model, Variable
    from mxfusion_tpu_torch.components.distributions import NegativeBinomial
    from mxfusion_tpu_torch.components.functions import NNFunction
    from mxfusion_tpu_torch.components.functions.operators import softplus
    from mxfusion_tpu_torch.components.variables import \
        PositiveTransformation
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(D, COUNT_HIDDEN),
                              torch.nn.Tanh(),
                              torch.nn.Linear(COUNT_HIDDEN, 1))
    m = Model()
    m.n = Variable()
    m.X = Variable(shape=(m.n, D))
    m.f = NNFunction(net, name="rate_net", input_shapes=[(TRAIN_B, D)],
                     device=dev)(m.X)
    m.mu = softplus(m.f)
    m.dispersion = Variable(shape=(1,),
                            transformation=PositiveTransformation(),
                            initial_value=np.array([NB_DISPERSION]))
    m.Y = NegativeBinomial.define_variable(mean=m.mu,
                                           dispersion=m.dispersion,
                                           shape=(m.n, 1))
    return m


def read_keyed():
    """R1's and R2's launches since the last ``zero_counts()``: read,
    as K1-K5's are, just after a main-path run."""
    from mxfusion_tpu_torch.ops import keyed_random
    return {"R1": keyed_random.keyed_standard_gamma.launches,
            "R2": keyed_random.keyed_poisson.launches}


def in_bytes(x):
    """The bytes of ``x`` that a kernel reads: one element where every
    element is one value broadcast (stride 0), else all of them."""
    one = all(st == 0 for st, n in zip(x.stride(), x.shape) if n > 1)
    return x.element_size() * (1 if one else x.numel())


def keyed_bound(n_bytes, hashes, float_ops, dtype):
    """R1's or R2's bound on this run's data: ``hashes`` Threefry calls
    (the plain version's count) of HASH_OPS integer operations at
    FP32_FLOP_S, and ``float_ops`` at their type's rate (counted here as
    the fp32 operations of the same time)."""
    import torch
    scale = 1.0 if dtype == torch.float32 else FP32_FLOP_S / FP64_FLOP_S
    return bound_ms(n_bytes, hashes * HASH_OPS + float_ops * scale,
                    FP32_FLOP_S)


def gamma_bound(alpha, hashes):
    """R1: the parameter read and the draw written once; three hashes
    and GAMMA_ROUND_OPS a round, one hash for each boost."""
    boosts = int((alpha < 1).sum())
    rounds = (int(hashes.sum()) - boosts) / 3
    n_bytes = in_bytes(alpha) + alpha.numel() * alpha.element_size() + 16
    return keyed_bound(n_bytes, int(hashes.sum()), rounds * GAMMA_ROUND_OPS,
                       alpha.dtype)


def poisson_bound(rate, hashes):
    """R2: the rate read and the count written once; a Knuth round is
    one hash and KNUTH_ROUND_OPS, a PTRS round two and PTRS_ROUND_OPS."""
    knuth = ((rate < 10) | rate.isnan()).reshape(-1)
    k_h, p_h = int(hashes[knuth].sum()), int(hashes[~knuth].sum())
    n_bytes = in_bytes(rate) + rate.numel() * rate.element_size() + 16
    return keyed_bound(n_bytes, k_h + p_h,
                       k_h * KNUTH_ROUND_OPS + p_h / 2 * PTRS_ROUND_OPS,
                       rate.dtype)


def keyed_check(label, got, want):
    """R1 or R2 against its plain version: (max |kernel − plain|, bits
    equal, elements outside KEYED_RTOL), checked against KEYED_FAR."""
    import torch
    torch.cuda.synchronize()
    same = (got == want) | (got.isnan() & want.isnan())
    far = ~((got - want).abs() <= KEYED_RTOL * want.abs()) & ~same
    n_far = int(far.sum())
    check(n_far <= KEYED_FAR * got.numel(), "{}: {} of {} elements of the "
          "kernel off the plain version beyond {} relative (tol {} of them)"
          .format(label, n_far, got.numel(), KEYED_RTOL, KEYED_FAR))
    err = float((got - want)[~(got.isnan() & want.isnan())].abs().max())
    return err, int(same.sum()), n_far


def ulps_apart(got, want):
    """Representable doubles between each pair of nonnegative float64
    draws (the distance of their bits); NaN pairs 0."""
    import torch
    both = got.isnan() & want.isnan()
    d = (got.view(torch.int64) - want.view(torch.int64)).abs()
    return torch.where(both, torch.zeros_like(d), d)


def keyed_schedule(kind, x, hashes):
    """The launch R1 or R2 makes over ``x`` on this card and the lane
    efficiency of its schedule, emulated from the plain version's
    ``hashes``, beside one thread an element's: (tile, warps an SM,
    thread efficiency, tile efficiency)."""
    import torch
    from mxfusion_tpu_torch.ops import keyed_random as kr
    tile, warps = kr.launch_plan(kind, x.dtype, x.numel())
    sched = kr.emulate_schedule(kind, x, hashes, tile)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return (tile, warps // sms, sched["thread_efficiency"],
            sched["tile_efficiency"])


def keyed_other_build(source):
    """R1 and R2 built from another ``keyed_draws.cu`` (a path; one with
    the C interface ``(dtype, parameter, stride, key, out, n, stream)``
    of both entries, as this one and the one-thread-an-element design
    have), with this one's nvcc flags: {R1, R2: draw(x, key)}, counting no launch. For
    comparing two designs in one run."""
    import ctypes
    import torch
    from mxfusion_tpu_torch.ops import cuda_build, keyed_random as kr
    out = ROOT / "build" / "keyed_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           *kr.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    check(proc.returncode == 0, "nvcc failed on {}:\n{}".format(
        source, proc.stderr[-4000:]))
    lib = ctypes.CDLL(str(out))
    ptr, cint, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def entry(fn):
        fn.argtypes = [cint, ptr, cll, ptr, ptr, cll, ptr]
        fn.restype = cint

        def draw(x, key):
            stride = 0 if all(st == 0 for st, n in zip(x.stride(), x.shape)
                              if n > 1) else 1
            x = x.contiguous() if stride else x
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            err = fn({torch.float32: 0, torch.float64: 1}[x.dtype],
                     x.data_ptr(), stride, key.data_ptr(), y.data_ptr(),
                     x.numel(), torch.cuda.current_stream().cuda_stream)
            check(err == 0, "the other build's launch failed ({})".format(
                err))
            return y
        return draw
    return {"R1": entry(lib.mxf_keyed_gamma),
            "R2": entry(lib.mxf_keyed_poisson)}


def keyed_kernel_checks(dev, card, seed, zero_counts, sync, other=None):
    """Phase 58a: the raw Threefry words of KEYED_N counters, then R1 at
    KEYED_N elements of each of GAMMA_ALPHAS and R2 at each of
    POISSON_RATES, float32 and float64, against their plain versions on
    the card: every float32 draw and every count bit-equal, float64 gamma
    at most GAMMA_F64_ULPS off in no more draws than GAMMA_F64_ULP_DRAWS
    at seed 0; a parameter broadcast from one value (read at stride 0)
    equal to the dense one; moments within MOMENT_SE standard errors;
    each time beside the library's, the bound and both schedules' lane
    efficiency; with ``other`` (``keyed_other_build``), that build's
    draws compared bit for bit and its time beside. Returns {R1, R2: max
    |kernel − plain|}."""
    import torch
    from mxfusion_tpu_torch.ops import keyed_random as kr
    R1, R2 = kr.keyed_standard_gamma, kr.keyed_poisson
    zero_counts()
    g = torch.Generator(dev).manual_seed(seed + 58)
    key = torch.randint(0, 2 ** 32, (2,), generator=g, dtype=torch.int64,
                        device=dev)
    x0 = torch.arange(KEYED_N, device=dev)
    x1 = torch.randint(0, 2 ** 32, (KEYED_N,), generator=g,
                       dtype=torch.int64, device=dev)
    words = kr.threefry2x32(key, x0, x1)
    plain_words = kr._threefry_torch(key[0], key[1], x0, x1)
    sync()
    check(all(torch.equal(a, b) for a, b in zip(words, plain_words)),
          "the kernel's Threefry-2x32 words differ from the plain version's")
    errs, notes = {"R1": 0.0, "R2": 0.0}, []
    for dtype in (torch.float32, torch.float64):
        for name, kind, draw, plain, params, bound in (
                ("R1", "gamma", R1, kr._gamma_torch, GAMMA_ALPHAS,
                 gamma_bound),
                ("R2", "poisson", R2, kr._poisson_torch, POISSON_RATES,
                 poisson_bound)):
            for p in params:
                x = torch.full((KEYED_N,), p, dtype=dtype, device=dev)
                got = draw(x, key)
                want, hashes = plain(x, key, with_hashes=True)
                label = "{} {} at {}".format(name, str(dtype)[6:], p)
                err, same, far = keyed_check(label, got, want)
                if name == "R1" and dtype == torch.float64:
                    ulps = ulps_apart(got, want)
                    off = int((ulps > 0).sum())
                    check(int(ulps.max()) <= GAMMA_F64_ULPS and (
                        seed != 0 or off <= GAMMA_F64_ULP_DRAWS.get(p, 0)),
                          "{}: {} draws off the plain version (tol {} at "
                          "seed 0), by up to {} ulps (tol {})".format(
                              label, off, GAMMA_F64_ULP_DRAWS.get(p, 0),
                              int(ulps.max()), GAMMA_F64_ULPS))
                    label += " (ulps apart: {})".format(
                        torch.bincount(ulps).tolist())
                else:
                    check(same == KEYED_N, "{}: {} of {} draws bit-equal to "
                          "the plain version; all expected".format(
                              label, same, KEYED_N))
                # one value broadcast, as the samplers pass it: read at
                # stride 0, the same draws
                check(torch.equal(draw(x[:1].expand(KEYED_N), key), got),
                      "{}: the broadcast parameter's draws differ from the "
                      "dense one's".format(label))
                check(bool(torch.isfinite(got).all()) and
                      bool((got >= 0).all()), "{}: draws not finite and "
                      "nonnegative".format(label))
                if name == "R2":
                    check(bool((got == got.round()).all()),
                          "{}: counts not whole".format(label))
                z_mean, z_var = moment_check(got.double().cpu().numpy()[
                    :, None], (p, p), None)
                check(z_mean <= MOMENT_SE and z_var <= MOMENT_SE,
                      "{}: mean {:.2f} and variance {:.2f} standard errors "
                      "off the closed form (tol {})".format(
                          label, z_mean, z_var, MOMENT_SE))
                ms = cuda_ms(lambda: draw(x, key), reps=20)
                lib = cuda_ms(lambda: torch._standard_gamma(x)
                              if name == "R1" else torch.poisson(x), reps=20)
                if other is not None:
                    theirs = other[name](x, key)
                    sync()
                    label += " (other build: bit-equal {}, {:.5f} ms)".format(
                        int(((theirs == got) | (theirs.isnan() & got.isnan()))
                            .sum()), cuda_ms(lambda: other[name](x, key),
                                             reps=20))
                b_ms, b_by = bound(x, hashes)
                tile, per_sm, eff_thread, eff_tile = keyed_schedule(
                    kind, x, hashes)
                errs[name] = max(errs[name], err)
                notes.append("{} bit-equal {}/{}, beyond 1e-6 {}, max |d| "
                             "{:.3g}, z {:.2f}/{:.2f}, hashes/elt {:.3f}, ms "
                             "{:.5f} (library {:.5f}, bound {:.5f} by {}, "
                             "share {:.1%}), tile {} at {} warps/SM, lane "
                             "efficiency {:.3f} (one thread an element "
                             "{:.3f})".format(
                                 label, same, KEYED_N, far, err, z_mean,
                                 z_var, float(hashes.double().mean()), ms,
                                 lib, b_ms, b_by, b_ms / ms, tile, per_sm,
                                 eff_tile, eff_thread))
    print("phase 58a keyed draws ({}): Threefry-2x32 words of {} counters "
          "equal to the bit; each draw from a broadcast parameter (stride "
          "0) equal to the dense one's | {}".format(
              card, KEYED_N, " | ".join(notes)), flush=True)
    return errs


def keyed_kernel_times(dev, card, seed, shape, mu, alpha, errs,
                       other=None):
    """Phase 58b: R1 and R2 timed at the main paths' shapes against their
    plain versions and the library calls, beside their bounds, both
    schedules' lane efficiency and the one-thread-an-element kernels'
    times: R1 on one STUDENT_T_SHAPE broadcast to ``shape`` (the
    Student-t propagation's draw of a chunk), R2 on the Poisson rates a
    ``NegativeBinomial`` of means ``mu`` and dispersion ``alpha`` draws
    (the count predictor's of a chunk); with ``other``
    (``keyed_other_build``), that build in the same turns. Updates
    ``errs``; returns {R1, R2: {"shape", "t", "bound", ...}}."""
    import torch
    from mxfusion_tpu_torch.ops import keyed_random as kr
    R1, R2 = kr.keyed_standard_gamma, kr.keyed_poisson
    g = torch.Generator(dev).manual_seed(seed + 59)
    key = torch.randint(0, 2 ** 32, (2,), generator=g, dtype=torch.int64,
                        device=dev)
    a = torch.broadcast_to(torch.tensor(STUDENT_T_SHAPE, device=dev), shape)
    r = 1.0 / alpha
    rate = R1(torch.full((COUNT_S,) + tuple(mu.shape[1:]), r, device=dev),
              key) * mu / r
    times = {}
    for name, kind, draw, plain, lib, x, bound in (
            ("R1", "gamma", R1, kr._gamma_torch, torch._standard_gamma, a,
             gamma_bound),
            ("R2", "poisson", R2, kr._poisson_torch, torch.poisson, rate,
             poisson_bound)):
        want, hashes = plain(x, key, with_hashes=True)
        err, same, far = keyed_check(name + " at the main path's shape",
                                     draw(x, key), want)
        check(same == x.numel(), "{} at the main path's shape: {} of {} "
              "draws bit-equal to the plain version; all expected".format(
                  name, same, x.numel()))
        t = {"kernel": [], "plain": [], "library": [], "other": []}
        if other is not None:
            check(torch.equal(other[name](x, key), want), "{}: the other "
                  "build differs from the plain version".format(name))
        for turn in range(2):   # plain, kernel, kernel, plain in turns
            t["plain"].append(cuda_ms(lambda: plain(x, key), reps=3))
            if other is not None and turn == 0:
                t["other"].append(cuda_ms(lambda: other[name](x, key)))
            t["kernel"].append(cuda_ms(lambda: draw(x, key)))
            if other is not None and turn == 1:
                t["other"].append(cuda_ms(lambda: other[name](x, key)))
            t["library"].append(cuda_ms(lambda: lib(x)))
        times[name] = {"shape": tuple(x.shape), "t": t,
                       "bound": bound(x, hashes), "same": same, "far": far,
                       "schedule": keyed_schedule(kind, x, hashes)}
        errs[name] = max(errs[name], err)
    rows = []
    for name, v in times.items():
        kernel = min(v["t"]["kernel"])
        rows.append(
            "{} at {} ({}): kernel {:.5f} (one thread an element {:.5f} on "
            "an H100 at 700 W), plain {:.5f}, library {:.5f} ({}), bound "
            "{:.5f} ({}), share {:.1%}; tile {} at {} warps/SM, lane "
            "efficiency {:.3f} (one thread an element {:.3f}); vs plain "
            "bit-equal {}, beyond 1e-6 {}{}".format(
                name, v["shape"], "Student-t shape 2.5" if name == "R1" else
                "the count predictor's rates", kernel,
                ONE_THREAD_AN_ELEMENT_MS[name], min(v["t"]["plain"]),
                min(v["t"]["library"]), "torch._standard_gamma"
                if name == "R1" else "torch.poisson", v["bound"][0],
                v["bound"][1], v["bound"][0] / kernel, v["schedule"][0],
                v["schedule"][1], v["schedule"][3], v["schedule"][2],
                v["same"], v["far"], "; other build {} ms (other, kernel, "
                "kernel, other)".format([round(m, 5) for m in v["t"][
                    "other"]]) if v["t"]["other"] else ""))
    print("phase 58b keyed draw times ({}): device ms per call behind a "
          "spin kernel, min of two | {}".format(card, " | ".join(rows)),
          flush=True)
    return times


def keyed_phases_alone(seed=0, other=None):
    """Phases 58a and 58b alone, on the card: build ``keyed_draws.cu``
    (its ptxas report printed), then 58a, then 58b at the Student-t
    chunk's shape and on a stand-in for the count predictor's means
    (exp(N(0, 0.5²)) at NB_DISPERSION, where the whole script uses the
    trained predictor's). ``other``: the path of another
    ``keyed_draws.cu`` to compare with in the same run
    (``keyed_other_build``). For iterating on R1 and R2; the whole script
    is the record."""
    import torch
    sys.path.insert(0, str(ROOT))
    from mxfusion_tpu_torch.ops import cuda_build, keyed_random as kr
    check(torch.cuda.is_available(), "phase 58 needs an NVIDIA GPU")
    dev, card = torch.device("cuda:0"), nvidia_smi()
    t0 = time.perf_counter()
    lib = cuda_build.build(kr.SOURCE, kr.NVCC_FLAGS)
    print("phase 2 build ({}): {} in {:.3f} s | ptxas: {}".format(
        card, lib.name, time.perf_counter() - t0, ptxas_summary(lib)),
        flush=True)

    def zero_counts():
        kr.keyed_standard_gamma.launches = 0
        kr.keyed_poisson.launches = 0
    builds = None if other is None else keyed_other_build(other)
    errs = keyed_kernel_checks(dev, card, seed, zero_counts,
                               torch.cuda.synchronize, builds)
    rng = np.random.default_rng(seed + 58)
    mu = np.exp(0.5 * rng.standard_normal((1, CHUNK, 1))).astype(np.float32)
    keyed_kernel_times(dev, card, seed, (DGP_SERVE_S, CHUNK, DGP_H),
                       torch.as_tensor(mu, device=dev), NB_DISPERSION, errs,
                       builds)
    return errs


def keyed_draw_phases(dev, card, seed, Xtr, Ytr, nb_counts, deep_gp,
                      normal_rows_s, loop_cls, zero_counts, sync,
                      keyed_earlier):
    """Phase 58: R1 and R2 (``csrc/keyed_draws.cu``) against their plain
    versions on the card at GAMMA_ALPHAS and POISSON_RATES, their times
    beside the plain versions', the library's and their bounds, then the
    slice at full width: phase 28's deep GP with a Student-t propagation
    and a count predictor, each exported and served on two generator
    seeds against the live predictor. ``deep_gp``: phase 28's (Z0s,
    trained state by name path); ``normal_rows_s``: phase 55's artifact
    rows/s; ``keyed_earlier``: the R1/R2 launches of the earlier main
    paths by phase. Returns the kernels' JSON rows, their launches those
    of every main path: each run's, counted from zero just before it and
    read just after it. Launches made to compare, to warm up, to export
    or to check a gradient are never read."""
    import torch
    from mxfusion_tpu_torch.inference import (
        BatchedPredictor, GradBasedInference, load_exported_predictor)
    from mxfusion_tpu_torch.modules import DeepGPRegression
    from mxfusion_tpu_torch.ops import keyed_random as kr
    t_phase = time.perf_counter()
    build = ROOT / "build"
    R1, R2 = kr.keyed_standard_gamma, kr.keyed_poisson
    # ---- 58a. the raw words and the draws against the plain versions
    errs = keyed_kernel_checks(dev, card, seed, zero_counts, sync)

    # ---- 58c (first: its live runs give (b) the main path's shapes). The
    # Student-t deep GP on phase 28's trained state
    chunks = -(-TRAIN_N // CHUNK)
    Z0s, dgp_state = deep_gp
    sm, salg = deep_gp_model(DeepGPRegression, Z0s,
                             rand_gen=student_t_rand_gen())
    sinf = loaded(GradBasedInference(salg, dtype="float32", device=dev),
                  dgp_state, {"X": Xtr[:CHUNK], "Y": Ytr[:CHUNK]})
    spred = BatchedPredictor(model=sm, infr_params=sinf.params,
                             observed=[sm.X], target_variables=[sm.Y.uuid],
                             chunk_size=CHUNK)
    spred.predict(X=Xtr[:CHUNK])
    spath = build / "chip_smoke_student_t_deep_gp.zip"
    t0 = time.perf_counter()
    spred.export(str(spath))
    sexport_s = time.perf_counter() - t0
    sdraws = [(d["kind"], tuple(d["shape"]), d["dtype"])
              for d in artifact_meta(spath)["draws"]]
    check([d[0] for d in sdraws] == ["normal", "key"], "the Student-t "
          "artifact records draws {}".format(sdraws))
    sserved = load_exported_predictor(str(spath))
    snodes = [str(n.target) for n in sserved._program.graph.nodes
              if "keyed_" in str(n.target)]
    check(snodes == ["mxfusion_tpu_torch.keyed_gamma.default"],
          "the Student-t program holds {}".format(snodes))
    sserved.predict(X=Xtr[:CHUNK])
    souts, swalls, slaunch, sstates = {}, {"live": [], "artifact": []}, \
        [], {}
    for s_ in (1, 2):
        for which, server in (("live", spred), ("artifact", sserved)):
            g = torch.Generator(dev).manual_seed(s_)
            zero_counts()
            t0 = time.perf_counter()
            souts[which, s_] = server.predict(X=Xtr, generator=g)[0]
            sync()
            swalls[which].append(time.perf_counter() - t0)
            slaunch.append((R1.launches, R2.launches))
            sstates[which, s_] = g.get_state()
        for a, b in zip(souts["artifact", s_], souts["live", s_]):
            check(a.shape == (1, TRAIN_N, 1) and np.isfinite(a).all()
                  and np.array_equal(a, b), "the Student-t artifact's "
                  "moments differ from the live predictor's on seed {}"
                  .format(s_))
        check(torch.equal(sstates["live", s_], sstates["artifact", s_]),
              "the generators' states differ after seed {}".format(s_))
    check(slaunch == [(chunks, 0)] * 4, "R1/R2 launches of the four "
          "Student-t runs {}; expected {} R1 each".format(slaunch, chunks))
    sgap = rel_err(souts["artifact", 1][0], souts["artifact", 2][0])
    check(sgap > 0, "the Student-t artifact's seeds give equal means")

    # the count predictor, MAP on phase 24's counts
    cm = count_model(dev, seed + 58)
    from mxfusion_tpu_torch.inference import MAP
    calg = MAP(model=cm, observed=[cm.X, cm.Y])
    zero_counts()
    cinf, cloop, _ = train_nongaussian(loop_cls, cm, calg, Xtr, nb_counts,
                                       1, dev, seed + 58)
    closses = [float(v) for v in cloop.losses]
    check(all(np.isfinite(closses)), "count predictor losses {}".format(
        closses))
    alpha = float(cinf.params[cm.dispersion].reshape(-1)[0])
    cpred = BatchedPredictor(model=cm, infr_params=cinf.params,
                             observed=[cm.X], target_variables=[cm.Y.uuid],
                             chunk_size=CHUNK, num_samples=COUNT_S)
    mu = BatchedPredictor(model=cm, infr_params=cinf.params,
                          observed=[cm.X], target_variables=[cm.mu.uuid],
                          chunk_size=CHUNK).predict(X=Xtr)[0]
    cpred.predict(X=Xtr[:CHUNK])
    cpath = build / "chip_smoke_counts.zip"
    request = build / "chip_smoke_counts_request.npy"
    served_out = build / "chip_smoke_counts_served.npz"
    for f in (cpath, served_out):
        if f.exists():
            f.unlink()
    np.save(request, Xtr)
    t0 = time.perf_counter()
    cpred.export(str(cpath))
    cexport_s = time.perf_counter() - t0
    cdraws = [d["kind"] for d in artifact_meta(cpath)["draws"]]
    check(cdraws == ["key", "key"], "the count artifact records draws {}"
          .format(cdraws))
    proc = subprocess.run(
        [sys.executable, "-c", SERVE_DRAWS.format(
            root=str(ROOT), artifact=str(cpath), request=str(request),
            out=str(served_out), chunk=CHUNK)],
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, "serving the count artifact failed:\n{}{}"
          .format(proc.stdout[-4000:], proc.stderr[-4000:]))
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    check(not child["held"], "the serving process imported {}".format(
        child["held"]))
    check(child["nodes"] == ["mxfusion_tpu_torch.keyed_gamma.default",
                             "mxfusion_tpu_torch.keyed_poisson.default"],
          "the count program holds {}".format(child["nodes"]))
    check(child["launches"] == [[chunks, chunks]] * 2, "the count "
          "artifact launched R1/R2 {}; expected {} each a request".format(
              child["launches"], chunks))
    cwalls, clive = [], []
    with np.load(served_out) as served:
        for s_ in (1, 2):
            g = torch.Generator(dev).manual_seed(s_)
            zero_counts()
            t0 = time.perf_counter()
            y = cpred.predict(X=Xtr, generator=g)[0]
            sync()
            cwalls.append(time.perf_counter() - t0)
            clive.append((R1.launches, R2.launches))
            check(y.shape == (COUNT_S, TRAIN_N, 1) and np.array_equal(
                y, served["y{}".format(s_)]), "the count artifact's draws "
                "differ from the live predictor's on seed {}".format(s_))
            check(np.array_equal(g.get_state().numpy(),
                                 served["state{}".format(s_)]),
                  "the generators' states differ after seed {}".format(s_))
    check(clive == [(chunks, chunks)] * 2, "the live count predictor "
          "launched R1/R2 {}; expected {} each".format(clive, chunks))
    check(np.isfinite(y).all() and y.min() >= 0 and np.array_equal(
        y, np.round(y)), "the served counts are not whole and nonnegative")
    # mu (1, N, 1): the predicted means; each draw's variance
    lam = mu + alpha * mu ** 2
    z_mean = abs(float((y - mu).sum())) / math.sqrt(float(
        lam.sum()) * COUNT_S)
    var_ratio = float(((y - mu) ** 2).sum() / (COUNT_S * lam).sum())
    check(z_mean <= MOMENT_SE and abs(var_ratio - 1) <= COUNT_VAR_RTOL,
          "the served counts' mean is {:.2f} standard errors off the "
          "predicted means (tol {}), their variance {:.4f} of the law's "
          "(tol {})".format(z_mean, MOMENT_SE, var_ratio, COUNT_VAR_RTOL))

    # ---- 58b. times at the main path's shapes, behind the spin kernel
    sync()
    zero_counts()
    # the Student-t propagation's gamma draw of one chunk: one value
    # broadcast, as sample_gamma passes it; the count predictor's means of
    # one chunk, its Poisson rates drawn from them as NegativeBinomial draws
    # them
    times = keyed_kernel_times(dev, card, seed, sdraws[0][1],
                               torch.as_tensor(mu[:, :CHUNK], device=dev),
                               alpha, errs)
    print("phase 58c slice at full width ({}): Student-t deep GP (phase "
          "28's RBF({}) -> {} -> RBF({}) -> 1, S={}, each normal n of the "
          "layers n·sqrt({}/g), g ~ Gamma({})), export {:.3f} s, draws {}, "
          "program nodes {} | {} rows on torch.Generator(\"cuda\") seeds "
          "1, 2: artifact bit-equal to the live predictor, generators' "
          "states equal, seeds' means part by {:.3e}, R1/R2 launches "
          "(live, artifact) {} | rows/s artifact {}, live {}; phase 55's "
          "normal-only artifact {} | count predictor (X -> Linear({}, {}) "
          "-> tanh -> Linear({}, 1) -> softplus -> NegativeBinomial), MAP "
          "on phase 24's counts, {} steps: losses {}, dispersion {:.4f}; "
          "export {:.3f} s, served in a process that builds no model: "
          "load {:.3f} s, program nodes {}, R1/R2 {} a request; {} counts "
          "a row on {} rows, seeds 1, 2: bit-equal to the live predictor "
          "(R1/R2 {}), generators' states equal; mean {:.2f} standard "
          "errors off the predicted means, pooled variance {:.4f} of the "
          "law's | rows/s artifact {}, live {}".format(
              card, D, DGP_H, DGP_H, sdraws[0][1][0], STUDENT_T_SHAPE,
              STUDENT_T_SHAPE, sexport_s, sdraws, snodes, TRAIN_N, sgap,
              slaunch, [round(TRAIN_N / w) for w in swalls["artifact"]],
              [round(TRAIN_N / w) for w in swalls["live"]],
              [round(v) for v in normal_rows_s], D, COUNT_HIDDEN,
              COUNT_HIDDEN, len(closses), [round(v, 1) for v in closses],
              alpha, cexport_s, child["load_s"], child["nodes"],
              child["launches"], COUNT_S, TRAIN_N, clive, z_mean, var_ratio,
              [round(TRAIN_N / w) for w in child["walls"]],
              [round(TRAIN_N / w) for w in cwalls]), flush=True)
    # every main path's R1/R2 launches, each run's read just after it
    paths = dict(keyed_earlier)
    paths["58c Student-t live and artifact"] = {
        "R1": sum(r1 for r1, _ in slaunch), "R2": sum(r2 for _, r2 in slaunch)}
    paths["58c count artifact, served"] = {
        "R1": sum(r1 for r1, _ in child["launches"]),
        "R2": sum(r2 for _, r2 in child["launches"])}
    paths["58c count, live"] = {
        "R1": sum(r1 for r1, _ in clive), "R2": sum(r2 for _, r2 in clive)}
    launches = {n: sum(c[n] for c in paths.values()) for n in ("R1", "R2")}
    print("phase 58d ({}): phases 20, 21 and 26 (BBVI, ADVI and the "
          "library's draws, the gamma draw's gradient) passed on the keyed "
          "draws with their bounds as they were | R1/R2 launches of the "
          "main paths: {} in all, by path {} | phase 58 took {:.1f} s"
          .format(card, launches, paths, time.perf_counter() - t_phase),
          flush=True)
    src = "mxfusion_tpu_torch/csrc/keyed_draws.cu"
    rows = {}
    for name, lib_name, replaces in (
            ("R1", "keyed_gamma", "mxfusion_tpu/components/distributions/"
             "random_gen.py:26"),
            ("R2", "keyed_poisson", "mxfusion_tpu/components/distributions/"
             "random_gen.py:66")):
        t, b = times[name]["t"], times[name]["bound"]
        check(launches[name] > 0, "{} was launched no time on the main "
              "paths".format(name))
        rows[name] = {"name": lib_name, "route": "cuda", "source": src,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": errs[name], "ms": min(t["kernel"]),
                      "plain_ms": min(t["plain"]), "bound_ms": b[0],
                      "bound_by": b[1], "library_ms": min(t["library"])}
    return rows


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
    from mxfusion_tpu_torch.inference import (
        BatchedPredictor, DeviceMinibatchLoop, GradBasedInference, MAP)
    from mxfusion_tpu_torch.ops import (cuda_build, cuda_kernels,
                                        fused_gram, keyed_random, linalg,
                                        precision)
    # the module; ops.batched_cholesky is the function, as in JAX
    batched_cholesky = importlib.import_module(
        "mxfusion_tpu_torch.ops.batched_cholesky")
    from mxfusion_tpu_torch.util.carryover import carryover_params

    dev = torch.device("cuda:0")

    def read_counts():
        return {"K1": cuda_kernels.rbf_kernel_matrix.launches,
                "K2": fused_gram._fwd_cuda.launches,
                "K3": fused_gram._bwd_cuda.launches,
                "K4": batched_cholesky._k4_cuda.launches,
                "K5": batched_cholesky._k5_cuda.launches}

    def zero_counts():
        cuda_kernels.rbf_kernel_matrix.launches = 0
        fused_gram._fwd_cuda.launches = 0
        fused_gram._bwd_cuda.launches = 0
        batched_cholesky._k4_cuda.launches = 0
        batched_cholesky._k5_cuda.launches = 0
        keyed_random.keyed_standard_gamma.launches = 0
        keyed_random.keyed_poisson.launches = 0

    RecordingLoop = recording_loop(DeviceMinibatchLoop, read_counts)
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print("phase 1 device: {} | nvidia-smi: {} | torch {} cuda {} | "
          "allow_tf32 matmul={} cudnn={}".format(
              kind, card, torch.__version__, torch.version.cuda,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32), flush=True)

    # ---- 2. build: one nvcc per source, all started together
    # each source with the extra nvcc flags its module loads it with
    sources = {"rbf_gram.cu": (), "fused_gram.cu": (),
               "batched_cholesky.cu": (),
               keyed_random.SOURCE: keyed_random.NVCC_FLAGS}
    cached = [cuda_build.library_path(*src).exists()
              for src in sources.items()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(cuda_build.build, sources, sources.values()))
    build_s = time.perf_counter() - t0
    for lib_path, was_cached in zip(libs, cached):
        print("phase 2 build: {} (cached={}) | ptxas: {}".format(
            lib_path.name, was_cached, ptxas_summary(lib_path)),
            flush=True)
    print("phase 2 build: {} sources in {:.3f} s | dynamic shared memory "
          "at D={}: {} | at n=32, 64, 128: K4 {} B and K5 {} B per block "
          "of {} matrices".format(
              len(sources), build_s, D, fused_gram.shared_memory_bytes(D),
              [batched_cholesky.shared_memory_bytes(n) for n in (32, 64, 128)],
              [batched_cholesky.shared_memory_bytes(n, 5)
               for n in (32, 64, 128)],
              [batched_cholesky.matrices_per_block(n) for n in (32, 64, 128)]),
          flush=True)

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
    # M % 4 != 0 takes 4-byte stores: M = 8191, and two samples whose
    # second K starts off a 16-byte boundary (N * M odd, or M = 130 with N
    # odd); M = 1
    Xm = torch.as_tensor(rng.standard_normal((2, 33, 8)), **f32)
    X2m = torch.as_tensor(rng.standard_normal((2, 130, 8)), **f32)
    X1 = torch.as_tensor(rng.standard_normal((2, 37, 4)), **f32)
    X21 = torch.as_tensor(rng.standard_normal((2, 1, 4)), **f32)
    ls_m = torch.as_tensor(rng.uniform(0.5, 2.0, (2, 8)), **f32)
    var2 = torch.ones((2, 1), **f32)
    # the materialized training arm's Kuf: each block walks about 16
    # column tiles through the prefetch
    Xuf = torch.as_tensor(rng.uniform(0.0, BOX, (TRAIN_B, D)), **f32)[None]
    # the exact GP's data (phase 14) and request (benchmarks/
    # gp_exact_1k.py:30-33): Kxx symmetric, Kxt, and Kxx on the copy
    # that a kernel's active_dims = [0, 1] takes (phase 16)
    erng = np.random.default_rng(args.seed + 11)
    Xe = erng.random((EXACT_N, EXACT_D)).astype(np.float32) * BOX
    Ye = (np.sin(Xe[:, :1] * 2.0) + erng.standard_normal(
        (EXACT_N, 1)).astype(np.float32) * 0.1).astype(np.float32)
    Xq = (erng.random((CHUNK, EXACT_D)) * BOX).astype(np.float32)
    Xe_t = torch.as_tensor(Xe, device=dev)[None]
    Xq_t = torch.as_tensor(Xq, device=dev)[None]
    Xe_2 = torch.index_select(Xe_t, -1, torch.arange(2, device=dev))
    cases = {"Kzx": (Z, Xk, ls_iso, var1), "Kuu": (Z, None, ls_iso, var1),
             "Kuf": (Z, Xuf, ls_iso, var1),
             "Kxx_gp": (Xe_t, None, var1, var1),
             "Kxt_gp": (Xe_t, Xq_t, var1, var1),
             "Kxx_gp_active_dims": (Xe_2, None, var1, var1),
             "ragged_ard": (Xr, X2r, ls_ard, var1),
             "M8191": (Z, Xk[:, :8191], ls_iso, var1),
             "S2_M130": (Xm, X2m, ls_m, var2),
             "S2_M1": (X1, X21, ls_m[:, :4].contiguous(), var2)}
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
        # the deep GP's inner-layer Kuf (phase 28) through RBF.K's route:
        # Z and the parameters at s = 1 against DGP_S samples of the
        # propagated inputs, expanded to one launch
        Zd, Ad, ls_d = deep_kuf_inputs(np.random.default_rng(args.seed + 46),
                                       dev)
        before = cuda_kernels.rbf_kernel_matrix.launches
        K = RBF(input_dim=DGP_H).K(Zd, Ad, rbf_lengthscale=ls_d,
                                   rbf_variance=var1)
        torch.cuda.synchronize()
        routed = cuda_kernels.rbf_kernel_matrix.launches - before
        P = cuda_kernels._rbf_torch(Zd, Ad, ls_d, var1)
        err = float((K - P).abs().max())
        check(routed == 1 and tuple(K.shape) == (DGP_S, M, TRAIN_B)
              and bool(torch.isfinite(K).all()) and err <= KERNEL_ATOL,
              "deep GP Kuf through the route: {} launches (expected 1), "
              "shape {}, max |kernel - plain| {}".format(
                  routed, tuple(K.shape), err))
        max_err = max(max_err, err)
        print("phase 3 kernel: deep GP Kuf_1 through RBF.K, Z {} and "
              "inputs {}: K1 launches {} {} max_abs_err={:.3e} (tol {:.0e})"
              .format(tuple(Zd.shape), tuple(Ad.shape), routed,
                      tuple(K.shape), err, KERNEL_ATOL), flush=True)
        del K, P
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
    # its gradient too: the backward products run later, outside the
    # forward's call, and must not drop to TF32 either
    A = Z[0].clone().requires_grad_(True)
    B = Xk[0].clone().requires_grad_(True)
    grng = np.random.default_rng(args.seed + 1)
    g = torch.as_tensor(grng.standard_normal((M, CHUNK)), **f32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gA, gB = torch.autograd.grad(precision.einsum("nd,md->nm", A, B),
                                     (A, B), g)
    finally:
        torch.set_float32_matmul_precision(old_tf32)
    grad_err = max(
        float((got.double() - want).abs().max() / want.abs().max())
        for got, want in ((gA, g.double() @ B.detach().double()),
                          (gB, g.double().T @ A.detach().double())))
    check(grad_err <= 1e-5, "HIGHEST einsum gradient under allow_tf32=True "
          "has relative error {} (TF32 leaked into the backward)"
          .format(grad_err))
    print("phase 3 kernel: HIGHEST einsum gradient with allow_tf32=True: "
          "relative error vs float64 {:.3e}".format(grad_err), flush=True)
    fused_errs = []
    for label, shape in (("train_shape", (M, TRAIN_B, D)),
                         ("ragged", (200, 5037, 7)),
                         ("dU_slice_boundaries", (128, 4104, 8)),
                         ("wide_N", (M, 100000, D))):
        inputs = fused_inputs(grng, *shape, dev, upper=0.05)
        fused_errs += [check_fused(fused_gram, inputs, label, lower)
                       for lower in (True, False)]
    fwd_err = max(e[0] for e in fused_errs)
    bwd_err = max(e[1] for e in fused_errs)

    # the route on inputs broadcast over s = 3 samples: K1 on the dense
    # copies in float32, the plain branch in float64
    (gp32, gp_k1), (svgp32, svgp_k1) = broadcast_cases(dev, "float32",
                                                       args.seed + 9)
    (gp64, gp_k1_64), (svgp64, svgp_k1_64) = broadcast_cases(
        dev, "float64", args.seed + 9)
    gp_rel = rel_err(gp32, gp64)
    svgp_rel = abs(svgp32 - svgp64) / abs(svgp64)
    check(gp_k1 == 1 and svgp_k1 == 2 and gp_k1_64 == svgp_k1_64 == 0,
          "sample-broadcast inputs launched K1 {} (GP log-pdf) and {} (SVGP "
          "bound) times in float32, {} and {} in float64; expected 1 (K), 2 "
          "(Kuu, Kuf), 0 and 0".format(gp_k1, svgp_k1, gp_k1_64, svgp_k1_64))
    check(gp32.shape == (3,) and gp_rel <= BROADCAST_RTOL
          and svgp_rel <= BROADCAST_RTOL,
          "sample-broadcast inputs: float32 (K1) vs float64: GP log-pdf {} "
          "rel {}, SVGP bound {} rel {} (tol {})".format(
              gp32, gp_rel, svgp32, svgp_rel, BROADCAST_RTOL))
    print("phase 3 kernel: inputs broadcast over s = 3 samples: GP log-pdf "
          "(K1 launches {}) and SVGP bound with sampled noise (K1 launches "
          "{}), float32 vs float64: rel {:.3e} and {:.3e} (tol {:.0e})"
          .format(gp_k1, svgp_k1, gp_rel, svgp_rel, BROADCAST_RTOL),
          flush=True)

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
    # Kzx in every chunk; Kuu once, when the predictor builds the factors
    # it keeps for its parameters
    check(launches == chunks + 1, "rbf_gram launched {} times for {} "
          "chunks; expected 1 per chunk (Kzx) and 1 for the predictor (Kuu)"
          .format(launches, chunks))
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
          "(1 per chunk and 1 for Kuu) | vs plain: mean rel {:.3e}, var abs {:.3e} | vs "
          "float64 ({} rows, cond(Kuu)={:.3e}): mean rel {:.3e}, var rel "
          "{:.3e}".format(list(REQUESTS), chunks, launches, mean_err,
                          var_err, F64_ROWS, cond, f64_mean, f64_var),
          flush=True)

    # ---- 5. timing, for information: K1 at serving's Kzx and Kuu, at the
    # materialized training arm's Kuf and at the exact GP's Kxx and Kxt
    rbf_ms = {}
    # the deep GP's Kuf_1 as the route hands it over: dense s = DGP_S copies
    Zd5, ls_d5, var5 = (t.expand((DGP_S,) + tuple(t.shape[1:])).contiguous()
                        for t in (Zd, ls_d, var1))
    with torch.no_grad():
        for label, A, X2t, ls, v in (("Kzx", Z, Xk, ls_iso, var1),
                                     ("Kuu", Z, None, ls_iso, var1),
                                     ("Kuf", Z, Xuf, ls_iso, var1),
                                     ("Kxx", Xe_t, None, var1, var1),
                                     ("Kxt", Xe_t, Xq_t, var1, var1),
                                     ("Kuf_deep", Zd5, Ad, ls_d5, var5)):
            t = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = cuda_kernels._rbf_torch if which == "plain" \
                    else cuda_kernels.rbf_kernel_matrix
                t[which].append(cuda_ms(lambda: fn(A, X2t, ls, v),
                                        5 if label == "Kuf_deep" else 50))
            samples, rows, dim = A.shape
            t["shape"] = (rows, rows if X2t is None else X2t.shape[1], dim)
            t["bound"] = rbf_bound(samples, *t["shape"], 1)
            t["samples"] = samples
            rbf_ms[label] = t
    del Zd5, Ad
    ms = rbf_ms["Kzx"]
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
    print("phase 5 timing ({}): rbf gram: {} | serving {} rows at "
          "chunk {}: kernel {} rows/s, plain {} rows/s".format(
              card, " | ".join(
                  "{} ({} x {} x {}, D={}): kernel {} ms, plain {} ms, "
                  "bound {:.5f} ms ({}), best kernel at {:.1%} of the bound"
                  .format(label, t["samples"], *t["shape"], t["kernel"],
                          t["plain"], t["bound"][0], t["bound"][1],
                          t["bound"][0] / min(t["kernel"]))
                  for label, t in rbf_ms.items()),
              BULK_ROWS, CHUNK, rows_s["kernel"], rows_s["plain"]),
          flush=True)

    # ---- 6. the training path: MAP + DeviceMinibatchLoop, fused and not
    trng = np.random.default_rng(args.seed + 2)
    Xtr, Ytr = make_training_data(trng)
    tm = headline_svgp(trng.uniform(0.0, BOX, (M, D)))
    alg = MAP(model=tm, observed=[tm.X, tm.Y])
    start = GradBasedInference(alg, dtype="float32", device=dev)
    start.initialize(X=Xtr[:TRAIN_B], Y=Ytr[:TRAIN_B],
                     generator=torch.Generator(dev).manual_seed(args.seed))
    start_state = {k: v.clone() for k, v in start.params.param_dict.items()}

    def train(fused):
        """One epoch from ``start_state``; per-step losses, launch counts
        and wall times, and the trained inference."""
        loop = RecordingLoop(batch_size=TRAIN_B,
                             rv_scaling={tm.Y: TRAIN_N / TRAIN_B})
        inf = GradBasedInference(alg, grad_loop=loop, dtype="float32",
                                 device=dev)
        inf.params.update_params(
            {k: v.clone() for k, v in start_state.items()})
        with contextlib.nullcontext() if fused else fused_gram.disabled():
            inf.run(X=Xtr, Y=Ytr, max_iter=1, learning_rate=3e-3)
        return loop, inf

    zero_counts()
    fused_loop, trained = train(True)
    train_launches = read_counts()
    plain_loop, _ = train(False)
    fused_losses = [float(x) for x in fused_loop.losses]
    plain_losses = [float(x) for x in plain_loop.losses]
    per_step = {"K1": 1, "K2": 1, "K3": fused_gram.BWD_LAUNCHES, "K4": 0,
                "K5": 0}
    for i, counts in enumerate(fused_loop.counts):
        check(counts == per_step, "fused step {} launched {}; expected {} "
              "(K1 for Kuu only)".format(i, counts, per_step))
    for i, counts in enumerate(plain_loop.counts):
        check(counts == {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "K5": 0},
              "materialized step {} "
              "launched {}; expected K1 twice (Kuu, Kuf) and no K2/K3"
              .format(i, counts))
    check(len(fused_losses) == len(plain_losses) == TRAIN_STEPS,
          "expected {} steps, got {} and {}".format(
              TRAIN_STEPS, len(fused_losses), len(plain_losses)))
    check(all(math.isfinite(x) for x in fused_losses + plain_losses),
          "non-finite training loss: {} {}".format(fused_losses,
                                                   plain_losses))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(fused_losses,
                                                       plain_losses))
    check(loss_rel <= TRAIN_LOSS_RTOL, "fused vs materialized losses part "
          "by {} relative: {} vs {}".format(loss_rel, fused_losses,
                                            plain_losses))
    # the bound at the start state on the first batch, float64 (plain)
    f64_loss = loss_and_grad_at(
        alg, start_state, fused_loop.first_batch, "float64", dev,
        grad=False, rv_scaling={tm.Y.uuid: TRAIN_N / TRAIN_B})[0]
    f64_rel = abs(fused_losses[0] - f64_loss) / abs(f64_loss)
    check(f64_rel <= F64_LOSS_RTOL, "first fused loss {} vs float64 {}: "
          "relative {}".format(fused_losses[0], f64_loss, f64_rel))
    pred = BatchedPredictor(model=tm, infr_params=trained.params,
                            observed=[tm.X], target_variables=[tm.Y.uuid],
                            chunk_size=CHUNK)
    mu, var = pred.predict(X=Xtr[:CHUNK])[0]
    check(mu.shape == var.shape == (1, CHUNK, 1) and np.isfinite(mu).all()
          and np.isfinite(var).all(), "serving the trained store gave "
          "{} {}".format(mu.shape, var.shape))
    step_s = {"fused": [], "plain": []}
    for _round in range(STEP_WALL_ROUNDS):
        for which in ("plain", "fused", "fused", "plain"):
            loop, _ = train(which == "fused")
            step_s[which] += loop.wall_s
    step_ms = {k: "median {:.3f} (quartiles {:.3f}-{:.3f}) of {}".format(
        *(float(q) for q in np.percentile(np.asarray(v) * 1e3,
                                          [50, 25, 75])), len(v))
               for k, v in step_s.items()}
    nan_loss, nan_launches = bound_at_singular_kuu(trng, Xtr, Ytr, dev,
                                                   read_counts)
    check(math.isnan(nan_loss) and nan_launches["K2"] == 1
          and nan_launches["K3"] == fused_gram.BWD_LAUNCHES,
          "bound at a Kuu that is not positive definite: loss {} (expected "
          "NaN, as in JAX), launches {}".format(nan_loss, nan_launches))
    print("phase 6 train: {} rows, B={}, M={}, D={}, {} Adam steps | per "
          "step launches fused {} materialized {} | losses fused {} "
          "materialized {} (max rel {:.3e}, tol {:.0e}) | first loss vs "
          "float64 {:.6f}: rel {:.3e} | served {} rows from the trained "
          "store | step wall ms ({}): fused {} materialized {} | Kuu not "
          "positive definite: fused loss {} (NaN as in JAX), gradient "
          "taken, nothing raised".format(
              TRAIN_N, TRAIN_B, M, D, TRAIN_STEPS, fused_loop.counts[0],
              plain_loop.counts[0], fused_losses, plain_losses, loss_rel,
              TRAIN_LOSS_RTOL, f64_loss, f64_rel, CHUNK, card,
              step_ms["fused"], step_ms["plain"], nan_loss), flush=True)

    # ---- 7. timing of K2 and K3, for information: lower=True is the
    # bound's call and the PERF.md yardstick
    Linv, Zs, Xs, var, dG = fused_inputs(grng, M, TRAIN_B, D, dev)
    fms = {"K2": [], "K2 plain": [], "K3": [], "K3 plain": [],
           "K2 dense": [], "K3 dense": [], "K3 plain, TF32 products": []}
    with torch.no_grad():
        G = fused_gram._fwd_cuda(Linv, Zs, Xs, var, True)
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "plain":
                fms["K2 plain"].append(cuda_ms(lambda: fused_gram
                                               ._fused_fwd_torch(
                                                   Linv, Zs, Xs, var, True),
                                               20))
                fms["K3 plain"].append(cuda_ms(lambda: fused_gram
                                               ._fused_bwd_torch(
                                                   Linv, Zs, Xs, var, dG,
                                                   True), 20))
                fms["K3 plain, TF32 products"].append(cuda_ms(
                    lambda: plain_bwd_tf32(fused_gram, Linv, Zs, Xs, var,
                                           dG), 20))
            else:
                fms["K2"].append(cuda_ms(lambda: fused_gram._fwd_cuda(
                    Linv, Zs, Xs, var, True), 20))
                fms["K3"].append(cuda_ms(lambda: fused_gram._bwd_cuda(
                    Linv, Zs, Xs, var, dG, G, True), 20))
                fms["K2 dense"].append(cuda_ms(lambda: fused_gram._fwd_cuda(
                    Linv, Zs, Xs, var, False), 20))
                fms["K3 dense"].append(cuda_ms(lambda: fused_gram._bwd_cuda(
                    Linv, Zs, Xs, var, dG, G, False), 20))
    k2_bound, k3_bound = fused_bounds(M, TRAIN_B, D)
    print("phase 7 timing ({}): M={} N={} D={}: {} | bound at lower=True "
          "(TF32 tensor cores): K2 {:.5f} ms ({}), K3 {:.5f} ms ({})".format(
              card, M, TRAIN_B, D, " | ".join("{} {} ms".format(k, v)
                                              for k, v in fms.items()),
              *k2_bound, *k3_bound), flush=True)

    # ---- 8. K4 and K5 against the plain version, on the card
    crng = np.random.default_rng(args.seed + 3)
    chol_errs = {"K4": 0.0, "K5": 0.0}
    for B, n in CHOL_SHAPES:
        errs, note = check_cholesky(batched_cholesky,
                                    spd_stack(crng, B, n, dev), "stack")
        for k in chol_errs:
            chol_errs[k] = max(chol_errs[k], errs[k])
        print("phase 8 cholesky: {} | max |kernel - plain| K4 {:.3e} K5 "
              "{:.3e}".format(note, errs["K4"], errs["K5"]), flush=True)
    for n in CHOL_NAN_N:
        bad = spd_stack(crng, 6, n, dev)
        bad[2] = -bad[2]
        bad[4, 0, 1] = bad[4, 1, 0] = 10.0 * bad[4, 0, 0]
        nan_plain = torch.isnan(linalg.cholesky(bad))
        for name, wrapper in (("K4", batched_cholesky._k4_cuda),
                              ("K5", batched_cholesky._k5_cuda)):
            L = wrapper(bad)
            check(torch.equal(torch.isnan(L), nan_plain)
                  and int(nan_plain.sum()) == n * (n + 1)
                  and bool((torch.triu(L, 1) == 0).all()),
                  "{} at n={}: NaN pattern on matrices that are not positive "
                  "definite differs from the plain version's".format(name, n))
    print("phase 8 cholesky: not positive definite (2 of 6 matrices) at n = "
          "{}: K4 and K5 give the plain version's NaN lower triangles".format(
              list(CHOL_NAN_N)), flush=True)

    # ---- 9. the MVN slice: structured-PPCA SVI at full width
    def sync():
        torch.cuda.synchronize()

    zero_counts()
    ppca, x_ppca, W0, ppca_start, ploop = train_ppca(
        dev, args.seed + 4, PPCA_N, PPCA_Q, PPCA_D, PPCA_STEPS,
        read_counts, sync)
    (zq, xq), (zp, xp) = sample_ppca(ppca, args.seed + 5)
    sync()
    ppca_launches = read_counts()
    per_step = {"K1": 0, "K2": 0, "K3": 0, "K4": 3, "K5": 0}
    for i, counts in enumerate(ploop.counts):
        check(counts == per_step, "PPCA step {} launched {}; expected {} "
              "(q's draw, the prior's and q's log-pdf)".format(
                  i, counts, per_step))
    check(ppca_launches["K4"] == 3 * PPCA_STEPS + 2, "PPCA path launched "
          "K4 {} times; expected {} (3 per step, 1 per forward sampling)"
          .format(ppca_launches["K4"], 3 * PPCA_STEPS + 2))
    losses = ploop.losses
    check(len(losses) == PPCA_STEPS and all(math.isfinite(v) for v in losses)
          and losses[-1] < losses[0], "PPCA losses do not fall: {}".format(
              losses))
    noise = np.random.default_rng(args.seed + 6).standard_normal(
        PPCA_S * PPCA_N * PPCA_Q)
    l32 = ppca_loss_at(ppca_start, x_ppca, noise, W0, "float32", dev)
    l64 = ppca_loss_at(ppca_start, x_ppca, noise, W0, "float64", dev)
    ppca_f64_rel = abs(l32 - l64) / abs(l64)
    check(ppca_f64_rel <= PPCA_F64_RTOL, "PPCA first loss float32 {} vs "
          "float64 {}: relative {}".format(l32, l64, ppca_f64_rel))
    step_wall = float(np.median(ploop.wall_s[1:]))
    print("phase 9 ppca: N={} Q={} D={} S={}, {} Adam steps (lr {}) | K4 "
          "launches per step {} | losses {:.6g} -> {:.6g} | first loss on "
          "fixed draws float32 {:.8g} vs float64 {:.8g}: rel {:.3e} (tol "
          "{:.0e}) | step wall ms ({}): median {:.3f} of {} (first {:.3f})"
          .format(PPCA_N, PPCA_Q, PPCA_D, PPCA_S, PPCA_STEPS, PPCA_LR,
                  ploop.counts[0]["K4"], losses[0], losses[-1], l32, l64,
                  ppca_f64_rel, PPCA_F64_RTOL, card, 1e3 * step_wall,
                  [round(1e3 * w, 3) for w in ploop.wall_s],
                  1e3 * ploop.wall_s[0]), flush=True)

    # ---- 9b. the MVN path through K4's block tier: structured PPCA at
    # Q = 128 (log-pdf stacks 2048 x 128^2)
    zero_counts()
    _, x128, W128, start128, loop128 = train_ppca(
        dev, args.seed + 8, PPCA128_N, PPCA128_Q, PPCA_D, PPCA128_STEPS,
        read_counts, sync)
    launches128 = read_counts()
    for i, counts in enumerate(loop128.counts):
        check(counts == per_step, "PPCA Q={} step {} launched {}; expected "
              "{}".format(PPCA128_Q, i, counts, per_step))
    check(launches128["K4"] == 3 * PPCA128_STEPS, "PPCA Q={} launched K4 {} "
          "times; expected {}".format(PPCA128_Q, launches128["K4"],
                                      3 * PPCA128_STEPS))
    losses128 = loop128.losses
    check(len(losses128) == PPCA128_STEPS
          and all(math.isfinite(v) for v in losses128)
          and losses128[-1] < losses128[0],
          "PPCA Q={} losses do not fall: {}".format(PPCA128_Q, losses128))
    noise128 = np.random.default_rng(args.seed + 10).standard_normal(
        PPCA_S * PPCA128_N * PPCA128_Q)
    l32_128 = ppca_loss_at(start128, x128, noise128, W128, "float32", dev)
    l64_128 = ppca_loss_at(start128, x128, noise128, W128, "float64", dev)
    rel128 = abs(l32_128 - l64_128) / abs(l64_128)
    check(rel128 <= PPCA_F64_RTOL, "PPCA Q={} first loss float32 {} vs "
          "float64 {}: relative {}".format(PPCA128_Q, l32_128, l64_128,
                                           rel128))
    print("phase 9b ppca: N={} Q={} D={} S={}, {} Adam steps | K4 (block "
          "tier, {}x{}^2 log-pdf stacks) launches per step {} | losses "
          "{:.6g} -> {:.6g} | first loss on fixed draws float32 {:.8g} vs "
          "float64 {:.8g}: rel {:.3e} (tol {:.0e}) | step wall ms ({}): "
          "median {:.3f} of {}".format(
              PPCA128_N, PPCA128_Q, PPCA_D, PPCA_S, PPCA128_STEPS,
              PPCA_S * PPCA128_N, PPCA128_Q, loop128.counts[0]["K4"],
              losses128[0], losses128[-1], l32_128, l64_128, rel128,
              PPCA_F64_RTOL, card, 1e3 * float(np.median(loop128.wall_s[1:])),
              [round(1e3 * w, 3) for w in loop128.wall_s]), flush=True)

    # ---- 10. forward sampling from the trained posterior and the prior
    q = ppca.inference_algorithm.posterior
    mu = ppca.params[q.q_mu].double()
    cov64 = posterior_covariance(ppca.params[q.q_A].double())
    Lq = torch.linalg.cholesky(cov64)
    for label, z, xs in (("posterior", zq, xq), ("prior", zp, xp)):
        check(tuple(z.shape) == (PPCA_FS, PPCA_N, PPCA_Q)
              and tuple(xs.shape) == (PPCA_FS, PPCA_N, PPCA_D)
              and bool(torch.isfinite(z).all())
              and bool(torch.isfinite(xs).all()),
              "{} samples: z {} x {} not finite or not ({}, {}, {}/{})"
              .format(label, tuple(z.shape), tuple(xs.shape), PPCA_FS,
                      PPCA_N, PPCA_Q, PPCA_D))
    eye = torch.eye(PPCA_Q, dtype=torch.float64, device=dev)
    moments = {"posterior": whitened_moments(zq.double(), mu, Lq),
               "prior": whitened_moments(zp.double(), 0.0,
                                         eye.expand(PPCA_N, -1, -1))}
    for label, (mean_err, cov_err) in moments.items():
        check(mean_err <= PPCA_MOMENT_TOL and cov_err <= PPCA_MOMENT_TOL,
              "{} draws whitened: |mean| {} |cov - I| {} > {}".format(
                  label, mean_err, cov_err, PPCA_MOMENT_TOL))
    print("phase 10 sampling: {} draws of z ({}, {}) and x ({}, {}) from "
          "the trained posterior and the prior; whitened by the float64 "
          "factor, max |mean| and max |cov - I|: posterior {:.4f} {:.4f}, "
          "prior {:.4f} {:.4f} (tol {:.4f})".format(
              PPCA_FS, PPCA_N, PPCA_Q, PPCA_N, PPCA_D,
              *moments["posterior"], *moments["prior"], PPCA_MOMENT_TOL),
          flush=True)

    # ---- 11. K5's own entry (the r3 variant; no library caller, as in
    # JAX) on the trained posterior's covariance stack
    cov32 = posterior_covariance(ppca.params[q.q_A]).detach().contiguous()
    zero_counts()
    with torch.no_grad():
        L5 = batched_cholesky.batched_cholesky_r3(cov32)
        sync()
        r3_launches = read_counts()
        L4 = batched_cholesky.cholesky(cov32)
    sync()
    r3_rel = float((L5 - L4).abs().max() / L4.abs().max())
    check(r3_launches["K5"] == 1 and r3_rel <= 2 * CHOL_RTOL,
          "batched_cholesky_r3 launched K5 {} times; K5 vs K4 on the "
          "posterior stack {} > {}".format(r3_launches["K5"], r3_rel,
                                           2 * CHOL_RTOL))
    print("phase 11 r3 entry: batched_cholesky_r3 on the posterior's "
          "({}, {}, {}) stack: K5 launches {}, vs K4 max |diff| / max |L| "
          "{:.3e}".format(PPCA_N, PPCA_Q, PPCA_Q, r3_launches["K5"], r3_rel),
          flush=True)

    # ---- 12. timing of K4 and K5, for information
    chol_ms = {}
    with torch.no_grad():
        for B, n in CHOL_TIMED:
            A = spd_stack(crng, B, n, dev)
            t = {"plain": [], "K4": [], "K5": [], "cholesky_ex": []}
            for which in ("plain", "K4", "K5", "cholesky_ex", "cholesky_ex",
                          "K5", "K4", "plain"):
                fn = {"plain": linalg.cholesky,
                      "K4": batched_cholesky._k4_cuda,
                      "K5": batched_cholesky._k5_cuda,
                      "cholesky_ex": torch.linalg.cholesky_ex}[which]
                t[which].append(cuda_ms(lambda: fn(A), 20))
            t["bound"] = chol_bound(B, n)
            chol_ms[(B, n)] = t
    print("phase 12 timing ({}): {}".format(card, " | ".join(
        "{}x{}^2: K4 {} K5 {} plain {} cholesky_ex {} ms, bound {:.5f} ms "
        "({}), best K4 at {:.1%} and best K5 at {:.1%} of it".format(
            B, n, *([round(v, 5) for v in t[k]]
                    for k in ("K4", "K5", "plain", "cholesky_ex")),
            t["bound"][0], t["bound"][1], t["bound"][0] / min(t["K4"]),
            t["bound"][0] / min(t["K5"]))
        for (B, n), t in chol_ms.items())), flush=True)

    # ---- 13. profile (information): where the PPCA SVI step's time goes
    trace = ROOT / "build" / "chip_smoke_ppca_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof = profile_ppca(dev, args.seed + 7, PROFILE_STEPS, trace)
    if prof is None:
        print("phase 13 profile: " + profile_summary(None, PROFILE_STEPS),
              flush=True)
    else:
        print("phase 13 profile ({}): structured PPCA, {} SVI steps under "
              "torch.profiler: {}".format(
                  card, PROFILE_STEPS, profile_summary(prof, PROFILE_STEPS)),
              flush=True)

    # ---- 14. the exact GP: MAP at the exact-GP bench's configuration,
    # then a request through BatchedPredictor and prior draws
    from mxfusion_tpu_torch.components.distributions.gp.kernels import (
        Linear, Matern52, White)
    from mxfusion_tpu_torch.inference import ForwardSampling
    from mxfusion_tpu_torch.modules import GPRegression, SparseGPRegression
    em, ealg = gp_model(GPRegression, RBF(input_dim=EXACT_D, variance=1.0,
                                          lengthscale=1.0), EXACT_D)
    eloop = recording_batch_loop(read_counts, sync)
    einf = GradBasedInference(ealg, grad_loop=eloop, dtype="float32",
                              device=dev)
    zero_counts()
    einf.run(X=Xe, Y=Ye, max_iter=EXACT_STEPS, learning_rate=EXACT_LR)
    sync()
    exact_launches = read_counts()
    one_k1 = {"K1": 1, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    for i, counts in enumerate(eloop.counts):
        check(counts == one_k1, "exact GP step {} launched {}; expected {} "
              "(Kxx)".format(i, counts, one_k1))
    elosses = eloop.losses
    check(len(elosses) == EXACT_STEPS
          and all(math.isfinite(v) for v in elosses)
          and elosses[-1] < elosses[0],
          "exact GP losses do not fall: {}".format(elosses))
    e64 = loss_and_grad_at(ealg, eloop.start_state, [Xe, Ye], "float64",
                           dev, grad=False)[0]
    e_rel = abs(elosses[0] - e64) / abs(e64)
    check(e_rel <= EXACT_F64_RTOL, "exact GP first loss float32 {} vs "
          "float64 {}: relative {}".format(elosses[0], e64, e_rel))
    refresh_posterior_cache(einf, [torch.as_tensor(Xe, device=dev),
                                   torch.as_tensor(Ye, device=dev)])
    zero_counts()
    epred = BatchedPredictor(model=em, infr_params=einf.params,
                             observed=[em.X], target_variables=[em.Y.uuid],
                             chunk_size=CHUNK)
    emu, evar = epred.predict(X=Xq)[0]
    (eprior,) = ForwardSampling(
        num_samples=4, model=em, observed=[em.X], infr_params=einf.params,
        target_variables=[em.Y]).run(
            X=Xe, generator=torch.Generator(dev).manual_seed(args.seed))
    sync()
    exact_serve = read_counts()
    check(exact_serve == {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "K5": 0},
          "exact GP request of one chunk and one draw launched {}; "
          "expected K1 twice (Kxt, the draw's Kxx)".format(exact_serve))
    check(emu.shape == (1, CHUNK, 1) and evar.shape == (1, CHUNK)
          and np.isfinite(emu).all() and np.isfinite(evar).all(),
          "exact GP prediction {} {} not finite or not (1, {}, 1), (1, {})"
          .format(emu.shape, evar.shape, CHUNK, CHUNK))
    check(tuple(eprior.shape) == (4, EXACT_N, 1)
          and bool(torch.isfinite(eprior).all()),
          "exact GP draws {} not finite or not (4, {}, 1)".format(
              tuple(eprior.shape), EXACT_N))
    ekern = em.Y.factor._module_graph.kernel
    emu64, evar64 = exact_gp_predict_f64(
        Xe.astype(np.float64), Ye.astype(np.float64),
        float(einf.params[ekern.lengthscale]),
        float(einf.params[ekern.variance]),
        float(einf.params[em.noise_var]), Xq[:F64_ROWS].astype(np.float64))
    e_mean = rel_err(emu[0, :F64_ROWS], emu64)
    e_var = rel_err(evar[0, :F64_ROWS], evar64)
    check(e_mean <= F64_RTOL and e_var <= F64_RTOL, "exact GP prediction "
          "vs float64: mean rel {}, variance rel {} (tol {})".format(
              e_mean, e_var, F64_RTOL))
    print("phase 14 exact GP: N={} D={} RBF, MAP + Adam lr {}, {} steps | "
          "K1 launches per step {} | losses {:.6g} -> {:.6g} | first loss "
          "float32 {:.8g} vs float64 {:.8g}: rel {:.3e} (tol {:.0e}) | "
          "request of {} rows: K1 {} (Kxt), vs float64 on {} rows mean rel "
          "{:.3e} var rel {:.3e} (tol {:.0e}) | 4 prior draws {} finite (K1 "
          "1) | step wall ms ({}): median {:.3f} over steps 2-{} (first "
          "{:.3f})".format(
              EXACT_N, EXACT_D, EXACT_LR, EXACT_STEPS, eloop.counts[0]["K1"],
              elosses[0], elosses[-1], elosses[0], e64, e_rel,
              EXACT_F64_RTOL, CHUNK, exact_serve["K1"] - 1, F64_ROWS,
              e_mean, e_var, F64_RTOL, tuple(eprior.shape), card,
              1e3 * float(np.median(eloop.wall_s[1:])), EXACT_STEPS,
              1e3 * eloop.wall_s[0]), flush=True)

    # ---- 15. the collapsed GP: full-batch MAP at N = 65536, M = 512,
    # D = 32, then a request through BatchedPredictor
    srng = np.random.default_rng(args.seed + 12)
    Xs_, Ys_ = Xtr[:SGP_N], Ytr[:SGP_N]
    Z0 = srng.uniform(0.0, BOX, (M, D))
    sm, salg = gp_model(
        SparseGPRegression, RBF(input_dim=D, variance=1.0,
                                lengthscale=math.sqrt(D)), D,
        inducing_inputs=Variable(shape=(M, D), initial_value=Z0))
    sloop = recording_batch_loop(read_counts, sync)
    sinf = GradBasedInference(salg, grad_loop=sloop, dtype="float32",
                              device=dev)
    zero_counts()
    sinf.run(X=Xs_, Y=Ys_, max_iter=SGP_STEPS, learning_rate=SGP_LR)
    sync()
    sgp_launches = read_counts()
    two_k1 = {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "K5": 0}
    for i, counts in enumerate(sloop.counts):
        check(counts == two_k1, "collapsed GP step {} launched {}; expected "
              "{} (Kuu, Kuf)".format(i, counts, two_k1))
    slosses = sloop.losses
    check(len(slosses) == SGP_STEPS
          and all(math.isfinite(v) for v in slosses),
          "collapsed GP losses not finite: {}".format(slosses))
    s64 = loss_and_grad_at(salg, sloop.start_state, [Xs_, Ys_], "float64",
                           dev, grad=False)[0]
    s_rel = abs(slosses[0] - s64) / abs(s64)
    check(s_rel <= SGP_F64_RTOL, "collapsed GP first loss float32 {} vs "
          "float64 {}: relative {}".format(slosses[0], s64, s_rel))
    tiers = {}
    try:
        for tier in ("highest", "default"):
            precision.set_data_precision(tier)
            tiers[tier] = loss_and_grad_at(salg, sloop.start_state,
                                           [Xs_, Ys_], "float32", dev)
    finally:
        precision.set_data_precision("default")
    (lh, gh), (ld, gd) = tiers["highest"], tiers["default"]
    tier_rel = max([abs(ld - lh) / abs(lh)] + [rel_err(gd[k], gh[k])
                                                for k in gh])
    check(tier_rel <= SGP_TIER_RTOL, "collapsed GP bound with the data tier "
          "at TF32 vs HIGHEST: loss {} vs {}, largest relative difference "
          "of the loss and the gradients {} > {}".format(
              ld, lh, tier_rel, SGP_TIER_RTOL))
    refresh_posterior_cache(sinf, [torch.as_tensor(Xs_, device=dev),
                                   torch.as_tensor(Ys_, device=dev)])
    Xsq = srng.uniform(0.0, BOX, (CHUNK, D)).astype(np.float32)
    zero_counts()
    spred = BatchedPredictor(model=sm, infr_params=sinf.params,
                             observed=[sm.X], target_variables=[sm.Y.uuid],
                             chunk_size=CHUNK)
    smu, svar = spred.predict(X=Xsq)[0]
    sync()
    sgp_serve = read_counts()
    check(sgp_serve == {"K1": 1, "K2": 0, "K3": 0, "K4": 0, "K5": 0},
          "collapsed GP request of one chunk launched {}; expected K1 once "
          "(Kxt)".format(sgp_serve))
    check(smu.shape == (1, CHUNK, 1) and svar.shape == (1, CHUNK)
          and np.isfinite(smu).all() and np.isfinite(svar).all(),
          "collapsed GP prediction {} {} not finite".format(smu.shape,
                                                            svar.shape))
    skern = sm.Y.factor._module_graph.kernel
    smu64, svar64 = sparse_gp_predict_f64(
        Xs_.astype(np.float64), Ys_.astype(np.float64),
        sinf.params[sm.Y.factor.inducing_inputs].double().cpu().numpy(),
        float(sinf.params[skern.lengthscale]),
        float(sinf.params[skern.variance]),
        float(sinf.params[sm.noise_var]), sm.Y.factor.jitter,
        Xsq[:F64_ROWS].astype(np.float64))
    s_mean = rel_err(smu[0, :F64_ROWS], smu64)
    s_var = rel_err(svar[0, :F64_ROWS], svar64)
    check(s_mean <= F64_RTOL and s_var <= F64_RTOL, "collapsed GP "
          "prediction vs float64: mean rel {}, variance rel {} (tol {})"
          .format(s_mean, s_var, F64_RTOL))
    print("phase 15 collapsed GP: N={} M={} D={} RBF, full batch, MAP + "
          "Adam lr {}, {} steps | K1 launches per step {} | losses {} | "
          "first loss float32 {:.8g} vs float64 {:.8g}: rel {:.3e} (tol "
          "{:.0e}) | data tier TF32 vs HIGHEST: loss and gradients rel "
          "{:.3e} (tol {:.0e}) | request of {} rows: K1 {} (Kxt), vs "
          "float64 on {} rows mean rel {:.3e} var rel {:.3e} (tol {:.0e}) | "
          "step wall ms ({}): median {:.3f} of {}".format(
              SGP_N, M, D, SGP_LR, SGP_STEPS, sloop.counts[0]["K1"],
              [round(v, 3) for v in slosses], slosses[0], s64, s_rel,
              SGP_F64_RTOL, tier_rel, SGP_TIER_RTOL, CHUNK, sgp_serve["K1"],
              F64_ROWS, s_mean, s_var, F64_RTOL, card,
              1e3 * float(np.median(sloop.wall_s)),
              [round(1e3 * w, 3) for w in sloop.wall_s]), flush=True)

    # ---- 16. the kernel family: the exact GP's log-pdf and gradient on
    # sum and product kernels, float32 (K1 for each RBF gram) vs float64
    family = []
    for label, make in (
            ("RBF(active_dims=[0, 1]) + Matern52 + White",
             lambda: RBF(2, active_dims=[0, 1]) + Matern52(EXACT_D)
             + White(EXACT_D, variance=0.05)),
            ("RBF * Linear", lambda: RBF(EXACT_D) * Linear(EXACT_D))):
        _, falg = gp_model(GPRegression, make(), EXACT_D)
        zero_counts()
        l32, g32 = loss_and_grad_at(falg, None, [Xe, Ye], "float32", dev)
        flaunch = read_counts()
        l64, g64 = loss_and_grad_at(falg, None, [Xe, Ye], "float64", dev)
        check(flaunch == one_k1, "{}: the log-pdf and its gradient launched "
              "{}; expected K1 once (one RBF gram)".format(label, flaunch))
        l_rel = abs(l32 - l64) / abs(l64)
        g_rel = max(rel_err(g32[k], g64[k]) for k in g64)
        check(l_rel <= EXACT_F64_RTOL and g_rel <= FAMILY_GRAD_RTOL,
              "{}: float32 vs float64 loss rel {} (tol {}), gradient rel "
              "{} (tol {})".format(label, l_rel, EXACT_F64_RTOL, g_rel,
                                   FAMILY_GRAD_RTOL))
        family.append("{}: K1 {}, loss {:.8g} rel {:.3e}, gradients ({}) "
                      "rel {:.3e}".format(label, flaunch["K1"], l32, l_rel,
                                          len(g64), g_rel))
    print("phase 16 kernel family: exact GP log-pdf and gradient at N={} "
          "D={}, float32 on the card vs float64 (tol loss {:.0e}, gradients "
          "{:.0e}) | {}".format(EXACT_N, EXACT_D, EXACT_F64_RTOL,
                                FAMILY_GRAD_RTOL, " | ".join(family)),
          flush=True)

    # ---- 17. profile (information): where the exact and collapsed GP
    # steps' time goes
    for label, alg, data, steps, lr in (
            ("exact GP (N={}, D={})".format(EXACT_N, EXACT_D), ealg,
             {"X": Xe, "Y": Ye}, PROFILE_STEPS, EXACT_LR),
            ("collapsed GP (N={}, M={}, D={})".format(SGP_N, M, D), salg,
             {"X": Xs_, "Y": Ys_}, SGP_STEPS, SGP_LR)):
        trace_gp = ROOT / "build" / "chip_smoke_{}_trace.json".format(
            label.split()[0])
        gp_prof = profile_steps(
            lambda loop, alg=alg: GradBasedInference(
                alg, grad_loop=loop, dtype="float32", device=dev),
            data, steps, lr, trace_gp)
        print("phase 17 profile ({}): {}, {} MAP steps under torch.profiler: "
              "{}".format(card, label, steps,
                          profile_summary(gp_prof, steps)), flush=True)

    # ---- 18-21. the mean-field slice: SVI, IWAE, BBVI and ADVI
    keyed21 = meanfield_phases(dev, card, args.seed, Xtr, Ytr, x_ppca, W0,
                               read_counts, zero_counts, sync)

    # ---- 22-26. the non-Gaussian SVGPs and the rest of the library
    ng_k1, labels, nb_counts, keyed26 = nongaussian_phases(
        dev, card, args.seed, Xtr, read_counts, zero_counts, sync,
        RecordingLoop)

    # ---- 27-31. LMC, deep GPs and natural gradients
    family, deep_gp_pred, deep_gp_state = gp_family_phases(
        dev, card, args.seed, Xtr, Ytr, labels, read_counts, zero_counts,
        sync, RecordingLoop)

    # ---- 32-34. checkpoint/resume, save/load, export
    persist = persistence_phases(dev, card, Xtr, Ytr, bulk, tm,
                                 start_state, trained, pred, RecordingLoop,
                                 read_counts, zero_counts, sync)

    # ---- 35-36. deep-kernel SVGP: training (K3's dXs into the network)
    # and serving
    deep_kernel, deep_kernel_pred = deep_kernel_phases(
        dev, card, args.seed, Xtr, Ytr, step_ms["fused"], read_counts,
        zero_counts, sync, RecordingLoop)

    # ---- 37-38. BASELINE config 5: Bayesian NN and VAE
    nn_model_phases(dev, card, args.seed, read_counts, zero_counts, sync)

    # ---- 39-41. the MCMC samplers; K1 in every potential over a GP
    sampler_k1 = sampler_phases(dev, card, args.seed, Xe, Ye, read_counts,
                                zero_counts, sync)

    # ---- 42-45. Laplace, thermodynamic integration, WAIC/PSIS-LOO and
    # the predictive check, observation masks
    evidence = evidence_phases(dev, card, args.seed, Xe, Ye, Xtr, Ytr,
                               read_counts, zero_counts, sync)

    # ---- 46-49. the Kalman ops, SSM MAP, stochastic volatility by HMC,
    # PILCO (K1 in its dynamics fits and rollouts)
    state_space_k1 = state_space_phases(dev, card, args.seed, read_counts,
                                        zero_counts, sync)

    # ---- 50-53. the native batcher, batches_per_call at the north star's
    # width, remat, data parallelism over a world of one (NCCL)
    loops = loop_options_phases(dev, card, args.seed, Xtr, Ytr, x_ppca, W0,
                                read_counts, zero_counts, sync, tm,
                                start_state)

    # ---- 54-55. the network artifact and the drawing artifact
    artifacts_k1, normal_rows_s = artifact_phases(
        dev, card, Xtr, deep_kernel_pred, deep_gp_pred, read_counts,
        zero_counts, sync)

    # ---- 56. the examples, on the card
    examples = example_phases(card, read_counts, zero_counts, sync)

    # ---- 57. the notebooks, on the card
    notebooks = notebook_phases(card, read_counts, zero_counts, sync)

    # ---- 58. the keyed gamma and Poisson draws (R1, R2), and the
    # drawing artifacts they let export
    keyed_rows = keyed_draw_phases(
        dev, card, args.seed, Xtr, Ytr, nb_counts, deep_gp_state,
        normal_rows_s, RecordingLoop, zero_counts, sync,
        {"21 draws": keyed21, "26 draws": keyed26,
         "56 examples": {n: examples[n] for n in ("R1", "R2")},
         "57 notebooks": {n: notebooks[n] for n in ("R1", "R2")}})

    check(not any(k == "jax" or k.startswith(("jax.", "mxfusion_tpu."))
                  or k == "mxfusion_tpu" for k in sys.modules),
          "JAX or the JAX package was imported")
    print(card)
    fused_src = "mxfusion_tpu_torch/csrc/fused_gram.cu"
    chol_src = "mxfusion_tpu_torch/csrc/batched_cholesky.cu"
    chol_main = chol_ms[CHOL_MAIN]

    def row(name, source, replaces, launches, err, t_ms, plain, bound,
            library):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t_ms, "plain_ms": plain,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": library}

    print(json.dumps({"kernels": [
        # no single PyTorch call computes K1, K2 or K3
        row("rbf_gram", "mxfusion_tpu_torch/csrc/rbf_gram.cu",
            "mxfusion_tpu/ops/pallas_kernels.py:89",
            launches + train_launches["K1"] + exact_launches["K1"]
            + exact_serve["K1"] + sgp_launches["K1"] + sgp_serve["K1"]
            + ng_k1 + family["K1"] + persist["K1"] + deep_kernel["K1"]
            + sampler_k1 + evidence["K1"] + state_space_k1 + loops["K1"]
            + artifacts_k1 + examples["K1"] + notebooks["K1"],
            max_err, min(ms["kernel"]),
            min(ms["plain"]), ms["bound"], None),
        row("fused_gram_fwd", fused_src,
            "mxfusion_tpu/ops/pallas_fused_gram.py:93",
            train_launches["K2"] + family["K2"] + persist["K2"]
            + deep_kernel["K2"] + evidence["K2"] + loops["K2"]
            + examples["K2"] + notebooks["K2"],
            fwd_err, min(fms["K2"]), min(fms["K2 plain"]), k2_bound, None),
        row("fused_gram_bwd", fused_src,
            "mxfusion_tpu/ops/pallas_fused_gram.py:109",
            train_launches["K3"] + family["K3"] + persist["K3"]
            + deep_kernel["K3"] + evidence["K3"] + loops["K3"]
            + examples["K3"] + notebooks["K3"],
            bwd_err, min(fms["K3"]), min(fms["K3 plain"]), k3_bound, None),
        row("batched_cholesky", chol_src,
            "mxfusion_tpu/ops/pallas_batched_cholesky.py:111",
            ppca_launches["K4"] + examples["K4"] + notebooks["K4"],
            chol_errs["K4"],
            min(chol_main["K4"]),
            min(chol_main["plain"]), chol_main["bound"],
            min(chol_main["cholesky_ex"])),
        row("batched_cholesky_r3", chol_src,
            "mxfusion_tpu/ops/pallas_batched_cholesky.py:56",
            r3_launches["K5"] + notebooks["K5"], chol_errs["K5"],
            min(chol_main["K5"]),
            min(chol_main["plain"]), chol_main["bound"],
            min(chol_main["cholesky_ex"])),
        keyed_rows["R1"], keyed_rows["R2"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
