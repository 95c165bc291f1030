"""The cells shrunk to sizes a CPU test run holds: every width and count
cut, the traffic's kind and parameters otherwise the cells' own."""
TINY = {
    "svgp.train": {
        "config": {"num_inducing": 16, "input_dim": 4, "lengthscale": 2.0},
        "traffic": {"rows": 4096, "batch": 1024, "trace_epochs": 1}},
    "dgp.train": {
        "config": {"num_inducing": 16, "input_dim": 4, "hidden_dims": [3],
                   "lengthscales": [2.0, 1.7]},
        "traffic": {"rows": 4096, "batch": 1024, "trace_epochs": 1}},
    "svgp.serve": {
        "config": {"num_inducing": 16, "input_dim": 4, "lengthscale": 2.0},
        "traffic": {"pool_rows": 8192, "min_rows": 300, "max_rows": 2000,
                    "chunk": 256, "trace_requests": 3}},
}
TRAINING = ("svgp.train", "dgp.train")
CELLS = tuple(TINY)
