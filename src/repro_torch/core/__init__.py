"""GridPilot core in PyTorch: the tiers, the twin and the rollout engine.

Import the modules themselves: ``repro_torch.core.engine`` (the unified
rollout, the primary surface) and ``repro_torch.core.pid`` (the Tier-1
closed loop, which runs the hand-written ``pid_update`` kernel on the
card).  The package imports nothing on its own, so ``grid`` and ``core``
can import each other's modules without a cycle.
"""
