"""Host utilities: phase timing, checkpointing, NaN checks, the device
resolver and the roofline model."""
