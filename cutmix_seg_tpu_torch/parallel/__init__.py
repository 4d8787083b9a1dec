"""Data parallelism over processes (one GPU each) and the multi-seed runner."""
