"""Runtime helpers: the straggler detector (:mod:`.straggler`)."""
