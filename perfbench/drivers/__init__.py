"""Window drivers, one a kind of traffic, found by the name a mix gives
under ``"driver"`` (:func:`perfbench.registry.driver`).

A driver's life in one run: ``setup()`` (inputs from the seed, warm-up:
the run's set-up), ``window(seconds, trace)`` (the measured window; its
end-to-end numbers), ``counters()`` (what the program counted), then
``release()`` (the program's state freed) and ``check(dtype)`` (the plain
reference over what the window produced, compared number by number).
"""


class Base:
    """What every driver holds: the cell, the run's seed, whether the
    window is traced, and the device (``"cpu"`` only in the tests)."""

    def __init__(self, cell: dict, seed: int, tracing: bool,
                 device: str = "cuda"):
        import torch

        self.cell = cell
        self.seed = seed
        self.tracing = tracing
        self.device = torch.device(device)
        self.sync = (torch.cuda.synchronize if self.device.type == "cuda"
                     else (lambda: None))
        self.mix = cell["traffic"]
        self.cfg = cell["config"]
