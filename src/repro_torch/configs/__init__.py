"""Ported architecture configs: each module exports ``CONFIG`` (the
published configuration) and ``SMOKE`` (a reduced one for CPU tests)."""
