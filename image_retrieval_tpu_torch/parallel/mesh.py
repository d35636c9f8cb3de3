"""Device mesh and row-sharding helpers — port of
``image_retrieval_tpu/parallel/mesh.py``.

The JAX package is one program driving every device of a
``jax.sharding.Mesh``: gallery rows and encoder batches split over the mesh's
``data`` axis, and its collectives merge per-shard results. The port keeps
that shape as one process driving a grid of ``torch.device``s: a sharded
function runs its shard-local body on each shard's device (queued on that
device's current stream, so the shards of real cards run concurrently) and
gathers the k-sized results onto the mesh's first device.

The trainers lay their parameters out the same way (``NamedSharding``): a
split tensor's parts on the devices along one axis, a whole one on the
mesh's first device, read elsewhere through ``.to()``.

A device may appear more than once in a mesh: ``[torch.device("cpu")] * 8``
or ``[cuda:0] * 4`` are virtual devices, the counterpart of the JAX tests'
``--xla_force_host_platform_device_count``. Their shards run one after
another on the one device, through the same split and merge as on real
cards.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from image_retrieval_tpu_torch.config import MeshConfig
from image_retrieval_tpu_torch.device import DeviceLike, resolve_device

Axis = Union[str, Tuple[str, ...]]


class Mesh:
    """A grid of devices with named axes: ``mesh.shape[axis]`` and
    ``"slice" in mesh.axis_names`` read as on a ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        given = np.array(devices, dtype=object)
        grid = np.empty(given.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            grid[pos] = torch.device(given[pos])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))

    @property
    def first(self) -> torch.device:
        """The device the merges gather onto."""
        return self.devices.flat[0]

    def distinct(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        out: List[torch.device] = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {[str(d) for d in self.devices.flat]})"


def make_mesh(cfg: Optional[MeshConfig] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A (data, model) mesh; ``data=-1`` takes every device the model axis
    leaves. Without `devices`, every visible card (``cuda:0 ... cuda:n-1``),
    as JAX's ``make_mesh()`` spans ``jax.devices()``; with no card that
    raises (``device.resolve_device``) and never falls back to the CPU."""
    cfg = cfg or MeshConfig()
    if devices is None:
        resolve_device("cuda")  # raises where there is no card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else n // model
    # data < 1 catches model > device count under data=-1 (a zero-device mesh)
    if data < 1 or data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    grid = np.empty(data * model, dtype=object)
    grid[:] = devices[: data * model]
    return Mesh(grid.reshape(data, model), cfg.axis_names)


def entry_mesh(device: Optional[DeviceLike], mesh: Optional[Mesh],
               cfg: Optional[MeshConfig] = None) -> Mesh:
    """An entry point's mesh from its ``device=`` and ``mesh=``: neither
    gives make_mesh(cfg) (every visible card), `device` a one-device mesh
    there, with cfg's axis names; both raise."""
    if device is not None and mesh is not None:
        raise ValueError("pass device= or mesh=, not both")
    if mesh is not None:
        return mesh
    if device is None:
        return make_mesh(cfg)
    names = (cfg or MeshConfig()).axis_names
    grid = np.empty((1,) * len(names), dtype=object)
    grid.flat[0] = resolve_device(device)
    return Mesh(grid, names)


def axis_names(axis: Axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def axis_size(mesh: Mesh, axis: Axis) -> int:
    """Shards along `axis`: one name, or a tuple of names (multi-slice row
    sharding uses ('slice', 'data'))."""
    size = 1
    for a in axis_names(axis):
        size *= mesh.shape[a]
    return size


def shard_devices(mesh: Mesh, axis: Axis = "data") -> List[torch.device]:
    """The device of each row shard, in shard order: row-major over the
    named axes (slice-major for ('slice', 'data')), the first device along
    every other axis (JAX replicates the shard there)."""
    names = axis_names(axis)
    dims = [mesh.axis_names.index(a) for a in names]
    out = []
    for pos in np.ndindex(*[mesh.devices.shape[d] for d in dims]):
        at = [0] * mesh.devices.ndim
        for d, p in zip(dims, pos):
            at[d] = p
        out.append(mesh.devices[tuple(at)])
    return out


def shard_rows(x, mesh: Mesh, axis: Axis = "data") -> List[torch.Tensor]:
    """The row blocks of an (N, ...) tensor or numpy array, one per shard in
    shard order, each on its shard's device. N must divide evenly."""
    devs = shard_devices(mesh, axis)
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    if t.shape[0] % len(devs):
        raise ValueError(f"{t.shape[0]} rows do not split over {len(devs)} shards")
    per = t.shape[0] // len(devs)
    return [t[i * per: (i + 1) * per].to(d) for i, d in enumerate(devs)]


def replicate(x, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """One copy of `x` per distinct device of the mesh."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    return {d: t.to(d) for d in mesh.distinct()}


Spec = Tuple[Optional[str], ...]


def row_spec(ndim: int, axis: str = "data") -> Spec:
    """The spec of a tensor whose leading axis splits over `axis`: rows of
    a gallery over ``data``, the layer axis of stacked layers over ``pipe``
    (parallel/pipeline.py::shard_stages)."""
    return (axis,) + (None,) * (ndim - 1)


class NamedSharding:
    """Where the parts of one tensor live on a mesh: ``spec`` names, per
    dimension of the tensor, the mesh axis it splits over (None: whole), as
    a ``jax.sharding.PartitionSpec`` does; at most one dimension splits.
    ``devices`` are the parts' homes in part order: along that axis, the
    first device of every other axis (``shard_devices``); an unsplit tensor
    has one home, the mesh's first device. A part is read on another device
    through ``.to()``, which autograd differentiates: its gradient comes
    back added into the part's."""

    def __init__(self, mesh: Mesh, spec: Spec):
        self.mesh, self.spec = mesh, tuple(spec)
        split = [(d, a) for d, a in enumerate(self.spec) if a is not None]
        if len(split) > 1:
            raise ValueError(f"spec {self.spec}: at most one dimension splits")
        self.dim, self.axis = split[0] if split else (None, None)
        self.devices = shard_devices(mesh, self.axis) if split else [mesh.first]

    @property
    def parts(self) -> int:
        return len(self.devices)

    def put(self, t: torch.Tensor) -> List[torch.Tensor]:
        """`t` cut into its parts, each a contiguous tensor on its home."""
        if self.dim is None:
            return [t.to(self.mesh.first).contiguous()]
        if t.shape[self.dim] % self.parts:
            raise ValueError(f"dimension {self.dim} of {tuple(t.shape)} does not split "
                             f"over {self.parts} {self.axis!r} shards")
        return [p.to(d).contiguous() for p, d in zip(t.chunk(self.parts, self.dim),
                                                     self.devices)]

    def gather(self, parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
        """The whole tensor on `device` from its parts."""
        if self.dim is None:
            return parts[0].to(device)
        return torch.cat([p.to(device) for p in parts], self.dim)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec}, {[str(d) for d in self.devices]})"


def on_device(device: torch.device):
    """Make `device` current for the launches inside (CUDA), so a kernel
    wrapper's default stream and a launch's pointers agree."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
