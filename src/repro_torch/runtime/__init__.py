"""Training runtime, port of ``repro.runtime``: ``fault_tolerance`` (the
restartable loop, the straggler watchdog, failure injection) and
``elastic`` (shrinking the mesh and resharding the state)."""
