"""Testing aids: the fault-injection plane (:mod:`.faults`) and the op
cases the parity tests and the card share (:mod:`.op_cases`)."""
