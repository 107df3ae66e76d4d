"""Multi-device Monte-Carlo on ``torch.distributed``: the ("snr", "data")
slot mesh and its counters step (:mod:`.mesh`), the operating-point grid
driver (:mod:`.montecarlo`) and the non-binary driver
(:mod:`.montecarlo_nb`)."""
