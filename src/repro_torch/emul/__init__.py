"""Guest-kernel emulation: the carry layout (:mod:`.state`) and the
batched service and data mover (:mod:`.engine`)."""
