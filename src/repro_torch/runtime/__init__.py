"""Training runtime, port of ``repro.runtime``."""
