"""The benchmark's own tests (see conftest.py)."""
