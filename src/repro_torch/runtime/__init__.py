"""Runtime: the barrel controller (:mod:`.controller`), the straggler
detector (:mod:`.straggler`) and the serving path's failure types
(:mod:`.fault_tolerance`)."""
