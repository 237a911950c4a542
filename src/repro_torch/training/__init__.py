"""Training: AdamW with the reference's schedule, and npz checkpoints
(port of ``repro.training``).

A parameter tree is the reference's nested dict with tensor leaves
(``models.convert.param_tree`` gives a model's, live); the optimizer
state mirrors it as ``{"mu", "nu", "step"}``.
"""
