"""Testing aids: the fault-injection plane (:mod:`.faults`)."""
