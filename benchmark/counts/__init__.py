"""Operation and byte counts from shapes, independent of any implementation."""
