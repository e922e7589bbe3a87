"""Core: dtypes, errors, the op registry and random generators."""
