"""Shared string constants."""

# Prefix used by inference algorithms to push state updates (e.g. cached
# Cholesky factors) out of the objective as auxiliary outputs.
SET_PARAMETER_PREFIX = "SET_"
