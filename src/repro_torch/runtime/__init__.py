"""Runtime: the barrel controller (:mod:`.controller`), the straggler
detector (:mod:`.straggler`), checkpoints (:mod:`.checkpoint`) and fault
tolerance (:mod:`.fault_tolerance`: the failure types and the training
supervisor)."""
