"""Mesh builders (port of ``repro.launch.mesh``).  Functions only:
importing this module touches no device.

A :class:`SweepMesh` is a single-process mesh, as JAX's single controller
sees one: named axes over an ndarray of ``torch.device`` s that one
process drives.  The sweep spreads its scenario lanes over the first axis
and, under a ``row_sharded`` state layout, the state rows over
``"state_row"`` (:mod:`repro_torch.core.sharded_state`).  It is not a
``torch.distributed`` ``DeviceMesh``: that needs one process a rank, and
the port's hand kernels run on plain tensors, one device each.

A device may appear more than once: such LOGICAL shards (the counterpart
of the reference's ``--xla_force_host_platform_device_count``) split the
state and the lanes exactly as distinct devices would, so a 4-way mesh
runs on the CPU (``devices=["cpu"] * 4``) or on one card
(``devices=["cuda:0"] * 4``).

The model zoo's production meshes (:func:`make_production_mesh`: (data
16, model 16) and (pod 2, data 16, model 16)) are the same object over
logical shards of one device by default.  The parameter, batch and cache
specs (:mod:`repro_torch.launch.sharding`) are statements about placement
on such a mesh; the MoE layer's expert-parallel branches compute shard by
shard (:func:`repro_torch.models.mlp.moe_forward`).  On the ``meta``
device a mesh holds shapes only: the dry run
(:mod:`repro_torch.launch.dryrun`) sizes its cells on one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def canonical_device(device) -> torch.device:
    """``device`` with its index spelled out (``"cuda"`` -> ``cuda:<the
    current device>``), so that two spellings of one card compare equal,
    as a tensor's ``.device`` does; a CUDA device raises without CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; build the mesh "
                               "from devices=['cpu', ...]")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class SweepMesh:
    """Named axes over an ndarray of devices (one process drives them).

    ``devices`` has one dimension an axis; ``shape`` maps each axis name
    to its size, as ``jax.sharding.Mesh.shape`` does.
    """

    axis_names: tuple
    devices: np.ndarray

    def __post_init__(self):
        devs = np.asarray(self.devices, dtype=object)
        if devs.ndim != len(self.axis_names) or devs.size == 0:
            raise ValueError(f"mesh axes {self.axis_names} do not fit a "
                             f"device array of shape {devs.shape}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        flat = [canonical_device(d) for d in devs.reshape(-1)]
        kinds = {d.type for d in flat}
        if len(kinds) != 1 or kinds - {"cpu", "cuda", "meta"}:
            raise ValueError(f"a mesh spans cuda, cpu or meta devices of "
                             f"one kind, not {sorted(kinds)}")
        canon = np.empty(devs.shape, dtype=object)
        canon.reshape(-1)[:] = flat
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        object.__setattr__(self, "devices", canon)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def home(self) -> torch.device:
        """The first device: where a run that uses no lane split lives."""
        return self.devices.reshape(-1)[0]

    @property
    def physical_devices(self) -> int:
        """Distinct devices under the mesh (logical shards count once)."""
        return len({str(d) for d in self.devices.reshape(-1)})

    def row_devices(self, block: int = 0) -> list:
        """The devices of lane block ``block`` along ``"state_row"`` (one
        device, the block's own, on a mesh without that axis)."""
        devs = self.devices
        if devs.ndim == 1:
            return [devs[block]]
        return list(devs[block].reshape(-1))


def _devices(n_devices: int | None, devices) -> list:
    if devices is not None:
        devs = [canonical_device(d) for d in devices]
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} "
                             "devices given")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass devices=['cpu', ...] for a mesh "
            "of logical CPU shards")
    n = n_devices or torch.cuda.device_count()
    if n > torch.cuda.device_count():
        raise ValueError(f"{n} devices asked, {torch.cuda.device_count()} "
                         "visible; list logical shards in devices=")
    return [torch.device("cuda", i) for i in range(n)]


def _mesh(shape: tuple, axes: tuple, devs: list) -> SweepMesh:
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return SweepMesh(axes, arr.reshape(shape))


def make_production_mesh(*, multi_pod: bool = False, devices=None
                         ) -> SweepMesh:
    """Single pod: (data=16, model=16), 256 shards.  Multi-pod: (pod=2,
    data=16, model=16), 512 shards.

    ``devices``: a list of 256 (512) devices, or one device repeated as
    logical shards; default: logical shards of the current CUDA device
    (raises without CUDA).  ``"meta"`` gives a shapes-only mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    if devices is None:
        devices = "cuda"
    if isinstance(devices, (str, torch.device)):
        devices = [canonical_device(devices)] * n
    devs = _devices(n, devices)
    return _mesh(shape, axes, devs)


def make_test_mesh(n_devices: int | None = None, *, devices=None):
    """Small mesh for tests: (data=2, model=n/2), or (1, 1) on one device."""
    devs = _devices(n_devices, devices)
    n = len(devs)
    if n == 1:
        return _mesh((1, 1), ("data", "model"), devs)
    return _mesh((2, n // 2), ("data", "model"), devs[: 2 * (n // 2)])


def make_sweep_mesh(n_devices: int | None = None, state_rows: int = 1, *,
                    devices=None) -> SweepMesh:
    """Mesh for the sweep (:class:`~repro_torch.core.sweep.SweepEngine`).

    1-D ``("scenario",)`` by default: each device replays a block of the
    scenario lanes.  ``state_rows > 1`` makes it 2-D ``("scenario",
    "state_row")``, whose second axis carries the ``row_sharded`` state
    layout: the state rows of every lane are split over ``state_rows``
    devices.  ``state_rows`` must divide the device count.  The devices
    are every visible CUDA device (raises without CUDA), the first
    ``n_devices`` of them, or ``devices`` (which may repeat a device:
    logical shards)."""
    devs = _devices(n_devices, devices)
    n = len(devs)
    if state_rows <= 1:
        return _mesh((n,), ("scenario",), devs)
    if n % state_rows:
        raise ValueError(
            f"state_rows={state_rows} must divide the device count {n}")
    return _mesh((n // state_rows, state_rows), ("scenario", "state_row"),
                 devs)


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that carry data parallelism (pod folds into DP)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s
