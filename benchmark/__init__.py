"""The synthanatomy_tpu_torch benchmark (see README.md)."""
