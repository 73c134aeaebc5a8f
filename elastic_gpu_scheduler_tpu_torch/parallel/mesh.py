"""The mesh: the scheduler's allocation as a grid of ranks by axis.

Counterpart of ``elastic_gpu_scheduler_tpu/parallel/mesh.py``.  The
scheduler writes a pod's chips onto it as annotations; this module turns
them into the job's mesh.  In the reference a mesh is a grid of JAX
devices and one process drives all of a host's chips.  Here one process
is one rank on one device (PyTorch's own idiom: ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` as ``torchrun`` sets them), so a mesh is a grid of ranks:
a host with 4 chips is 4 ranks, and the reference's process-major device
order (``gang_rank_order``) is the rank order.

The layout functions are pure: ``make_mesh``, ``hierarchical_mesh``,
``gang_mesh`` (for a gang of one, or given ``devices``) and
``mesh_from_allocation`` take a list of ``RankDevice`` (a rank id with the
attributes the reference reads off a JAX device: ``process_index``,
``coords``, ``slice_index``, ``core_on_chip``) and need no process group.
``Mesh.connect()`` then creates one process group for each group of ranks
that a collective spans (``parallel/collectives.py``); every rank of the
world calls it, in the same order.

Axes, as in the reference:

    data    — pure data parallelism (gradient all-reduce)
    fsdp    — fully-sharded data parallel (weight all-gather, gradient
              reduce-scatter)
    expert  — expert parallelism (models/moe.py)
    pipe    — pipeline parallelism (parallel/pipeline.py)
    tensor  — tensor parallelism (column / row-parallel products)
    seq     — sequence parallelism (ring attention, parallel/ring.py)
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

AXES = ("data", "fsdp", "expert", "pipe", "tensor", "seq")

# the scheduler's annotations (own copies of the reference's utils/consts)
ANNOTATION_CONTAINER_PREFIX = "elasticgpu.io/container-"  # + name → "x.y.z,..."
ANNOTATION_GANG_SIZE = "elasticgpu.io/gang-size"
ANNOTATION_GANG_SLICES = "elasticgpu.io/gang-slices"  # "sliceA,sliceB,..."
ANNOTATION_GANG_RANK = "elasticgpu.io/gang-rank"
ANNOTATION_GANG_PEERS = "elasticgpu.io/gang-peers"

Coord = tuple[int, ...]


def parse_coord(s: str) -> Coord:
    return tuple(int(p) for p in s.split("."))


def format_coord(c: Coord) -> str:
    return ".".join(str(v) for v in c)


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape: axis name → size.  Product must equal #ranks."""

    data: int = 1
    fsdp: int = 1
    expert: int = 1
    pipe: int = 1
    tensor: int = 1
    seq: int = 1

    @property
    def sizes(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXES}

    @property
    def num_devices(self) -> int:
        n = 1
        for v in self.sizes.values():
            n *= v
        return n

    @classmethod
    def for_devices(cls, n: int, tensor: int = 1, seq: int = 1,
                    fsdp: Optional[int] = None) -> "MeshSpec":
        """Default factoring: given tensor/seq, put the rest in fsdp (or
        split data×fsdp when ``fsdp`` is given)."""
        rest, r = divmod(n, tensor * seq)
        if r:
            raise ValueError(f"{n} devices not divisible by tensor*seq={tensor * seq}")
        if fsdp is None:
            return cls(data=1, fsdp=rest, tensor=tensor, seq=seq)
        data, r = divmod(rest, fsdp)
        if r:
            raise ValueError(f"residual {rest} not divisible by fsdp={fsdp}")
        return cls(data=data, fsdp=fsdp, tensor=tensor, seq=seq)


def parse_mesh(text: str) -> MeshSpec:
    """``"tensor=2,seq=2"`` → MeshSpec; unnamed axes are 1."""
    sizes = {a: 1 for a in AXES}
    for part in text.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in sizes:
            raise ValueError(f"unknown mesh axis {k!r}; choose from {list(AXES)}")
        try:
            sizes[k] = int(v)
        except ValueError:
            raise ValueError(f"mesh axis {k}={v!r} is not an integer") from None
        if sizes[k] < 1:
            raise ValueError(f"mesh axis {k}={sizes[k]} must be at least 1")
    return MeshSpec(**sizes)


@dataclass(frozen=True)
class RankDevice:
    """One rank as the layout functions see it: its id (the global rank)
    and what the reference reads off a JAX device."""

    id: int
    process_index: int = 0
    coords: Optional[Coord] = None
    slice_index: Optional[int] = None
    core_on_chip: int = 0


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """A grid of ranks, shaped ``spec`` in ``AXES`` order.  ``devices`` is
    that grid of ``RankDevice``; ``ranks`` the grid of their ids."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, spec: MeshSpec):
        self.spec = spec
        self.devices = devices
        self.ranks = np.vectorize(lambda d: d.id, otypes=[np.int64])(devices)
        self._coords = {int(r): idx for idx, r in np.ndenumerate(self.ranks)}
        self._groups: Optional[dict] = None
        self._object_group = None  # gloo, over the whole mesh (``object_group``)
        self.rank: Optional[int] = None  # this process's rank, once connected
        self.backend = ""

    @property
    def shape(self) -> dict[str, int]:
        return self.spec.sizes

    @property
    def size(self) -> int:
        return self.spec.num_devices

    def coords(self, rank: int) -> tuple[int, ...]:
        return self._coords[int(rank)]

    def axis_index(self, axis: str, rank: Optional[int] = None) -> int:
        return self.coords(self.rank if rank is None else rank)[AXES.index(axis)]

    def axes_index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """This rank's index along the flattened ``axes`` (first axis major),
        as a dimension sharded over them is cut."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.axis_index(a, rank)
        return i

    def axes_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def group_ranks(self, axes: Sequence[str], rank: Optional[int] = None) -> list[int]:
        """The ranks that share ``rank``'s coordinates off ``axes``, ordered
        by their index along ``axes``."""
        axes = _axes(axes)
        c = list(self.coords(self.rank if rank is None else rank))
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            for a, i in zip(axes, idx):
                c[AXES.index(a)] = i
            out.append(int(self.ranks[tuple(c)]))
        return out

    def all_groups(self, axes: Sequence[str]) -> list[list[int]]:
        """Every group of ``axes``, each ordered as ``group_ranks``."""
        seen, out = set(), []
        for r in self.ranks.flat:
            g = self.group_ranks(axes, int(r))
            if g[0] not in seen:
                seen.add(g[0])
                out.append(g)
        return out

    # -- process groups -------------------------------------------------------

    def connect(self) -> "Mesh":
        """Create one process group for every set of the mesh's axes longer
        than 1 (a collective call: every rank of the world makes it, in the
        same order, whether it is in this mesh or not, as
        ``torch.distributed.new_group`` needs).  Axes of size 1 take part in
        no group: a collective over them alone is a no-op.  A mesh of more
        than one rank also gets a gloo group over all of its ranks
        (``object_group``), the group of every axis when the backend is
        gloo already."""
        import torch.distributed as dist

        if self._groups is not None:
            return self
        if not dist.is_initialized():
            if self.size != 1:
                raise RuntimeError(
                    f"a mesh of {self.size} ranks needs torch.distributed initialized "
                    "(parallel/distributed.maybe_initialize_distributed)")
            self.rank, self._groups = int(self.ranks.flat[0]), {}
            return self
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        wide = [a for a in AXES if self.shape[a] > 1]
        groups = {}
        for k in range(1, len(wide) + 1):
            for axes in itertools.combinations(wide, k):
                for ranks in self.all_groups(axes):
                    pg = _process_group(sorted(ranks))
                    if self.rank in ranks:
                        groups[axes] = pg
        if self.size > 1:
            ranks = sorted(int(r) for r in self.ranks.flat)
            if self.backend == "gloo":
                self._object_group = groups.get(tuple(wide))
            else:
                pg = _process_group(ranks, "gloo")
                self._object_group = pg if self.rank in ranks else None
        self._groups = groups
        return self

    def object_group(self):
        """A gloo process group over every rank of the mesh for host
        objects, or None on a mesh of one rank: the serving engine's
        tickets travel through it whatever the backend of the mesh's own
        groups."""
        if self._groups is None:
            raise RuntimeError("mesh not connected: call Mesh.connect() on every rank")
        if self.size == 1:
            return None
        if self._object_group is None:
            raise ValueError(f"rank {self.rank} is not in {self!r}")
        return self._object_group

    def group(self, axes) -> Optional[tuple]:
        """(process group, ranks ordered along ``axes``) of this rank, or
        None when ``axes`` span one rank."""
        axes = _axes(axes)
        if self._groups is None:
            raise RuntimeError("mesh not connected: call Mesh.connect() on every rank")
        if self.rank not in self._coords:
            raise ValueError(f"rank {self.rank} is not in {self!r}")
        if self.axes_size(axes) == 1:
            return None
        wide = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        return self._groups[wide], self.group_ranks(axes)

    @property
    def connected(self) -> bool:
        return self._groups is not None

    def __repr__(self) -> str:
        return f"Mesh({self.spec.sizes}, ranks={self.ranks.reshape(-1).tolist()})"


# one process group a set of ranks, shared by every mesh and axis tuple
# that spans it, keyed with the world it lives in; every rank of the world
# creates the same groups in the same order, so every rank holds the same
# cache
_PROCESS_GROUPS: dict = {}


def _process_group(ranks: list[int], backend: Optional[str] = None):
    """The group of ``ranks`` on the world's backend, or on ``backend``
    when it names another (a gloo group beside NCCL ones)."""
    import torch.distributed as dist

    if backend == str(dist.get_backend()):
        backend = None
    if len(ranks) == dist.get_world_size() and backend is None:
        return dist.group.WORLD
    key = (id(dist.group.WORLD), tuple(ranks), backend)
    if key not in _PROCESS_GROUPS:
        _PROCESS_GROUPS[key] = dist.new_group(ranks, backend=backend)
    return _PROCESS_GROUPS[key]


def _world_devices() -> list[RankDevice]:
    """One ``RankDevice`` a rank of the world (one, without a process group)."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return [RankDevice(i) for i in range(n)]


def _grid(flat: list, spec: MeshSpec) -> Mesh:
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    return Mesh(arr.reshape(tuple(spec.sizes[a] for a in AXES)), spec)


def make_mesh(spec: MeshSpec, devices: Optional[Sequence[RankDevice]] = None) -> Mesh:
    """A mesh over the given (or all) ranks, ordered by their chips'
    coordinates when they carry them, by rank otherwise."""
    devs = list(devices) if devices is not None else _world_devices()
    if len(devs) != spec.num_devices:
        raise ValueError(f"mesh spec needs {spec.num_devices} devices, have {len(devs)}")
    return _grid(_ici_order(devs), spec)


def _ici_order(devs: list) -> list:
    """Sort by physical coordinates when available, so adjacent mesh
    positions are link neighbours."""

    def key(d):
        c = getattr(d, "coords", None)
        if c is None:
            return (0, d.id)
        return (0, *tuple(c), getattr(d, "core_on_chip", 0))

    try:
        return sorted(devs, key=key)
    except TypeError:  # heterogeneous keys; keep enumeration order
        return devs


def _slice_partition(devs: list, n_slices: int) -> list[list]:
    """Per-slice groups: by ``slice_index`` when the ranks carry one (the
    hardware's count is authoritative), else contiguous equal chunks."""
    by_slice: dict[int, list] = {}
    for d in devs:
        si = getattr(d, "slice_index", None)
        if si is None:
            by_slice = {}
            break
        by_slice.setdefault(si, []).append(d)
    if by_slice:
        if len(by_slice) != n_slices:
            raise ValueError(
                f"devices span {len(by_slice)} hardware slices but the "
                f"gang annotation says {n_slices}; stale placement?")
        return [_ici_order(by_slice[k]) for k in sorted(by_slice)]
    if len(devs) % n_slices:
        raise ValueError(f"{len(devs)} devices not divisible by {n_slices} slices")
    per = len(devs) // n_slices
    return [devs[i * per:(i + 1) * per] for i in range(n_slices)]


def hierarchical_mesh(spec: MeshSpec, n_slices: int,
                      devices: Optional[Sequence[RankDevice]] = None) -> Mesh:
    """Mesh for a gang that straddles slices: the data axis is outermost
    and spans slices (its one gradient all-reduce a step is what can bear
    the slow link); every other axis lies inside one slice.  Rank order is
    slice-major.  Needs ``spec.data % n_slices == 0`` and each slice to
    hold ``(data // n_slices) × the other axes`` ranks."""
    devs = list(devices) if devices is not None else _world_devices()
    if spec.data % n_slices:
        raise ValueError(
            f"data axis {spec.data} must be divisible by {n_slices} "
            "slices (the DCN boundary lives inside the data axis)")
    if len(devs) != spec.num_devices:
        raise ValueError(f"mesh spec needs {spec.num_devices} devices, have {len(devs)}")
    groups = _slice_partition(devs, n_slices)
    inner = spec.num_devices // spec.data
    per_slice = (spec.data // n_slices) * inner
    for g in groups:
        if len(g) != per_slice:
            raise ValueError(
                f"slice group of {len(g)} devices != {per_slice} "
                "(= data/n_slices × inner axes); the gang placement does "
                "not tile the mesh spec")
    return _grid([d for g in groups for d in g], spec)


def classify_replica_groups(groups: Sequence[Sequence[int]], per_slice: int
                            ) -> tuple[list[list[int]], list[list[int]]]:
    """Split groups of rank ids into (cross-slice, intra-slice) by whether
    a group's ranks fall on both sides of a ``per_slice`` boundary.  The
    reference parses the groups out of compiled HLO; the port's groups are
    the mesh's own (``Mesh.all_groups``), or HLO-style text, which is
    parsed the reference's way."""
    if isinstance(groups, str):
        groups = [
            [int(x) for x in g.split(",")]
            for m in re.finditer(r"replica_groups=\{(\{[0-9,{}]+\})\}", groups)
            for g in re.findall(r"\{([0-9,]+)\}", m.group(1))
        ]
    groups = [list(g) for g in groups]
    crosses = [g for g in groups if len({d // per_slice for d in g}) > 1]
    intra = [g for g in groups if len(g) > 1 and len({d // per_slice for d in g}) == 1]
    return crosses, intra


def gang_slices_from_annotations(annotations: dict) -> list[str]:
    """The ordered slice list a straddling gang's commit wrote (empty for
    a single-slice placement)."""
    raw = (annotations or {}).get(ANNOTATION_GANG_SLICES, "")
    return [s for s in raw.split(",") if s]


def coords_from_annotations(annotations: dict, container: str) -> list[Coord]:
    """The scheduler's chip-coordinate annotation for a container."""
    raw = (annotations or {}).get(ANNOTATION_CONTAINER_PREFIX + container, "")
    return [parse_coord(p) for p in raw.split(",") if p]


def gang_rank_order(devs: list) -> list:
    """Gang-rank-major order (``process_index`` = the member's journaled
    gang rank), coordinate-ordered within a member."""

    def key(d):
        c = getattr(d, "coords", None)
        pi = getattr(d, "process_index", 0)
        if c is None:
            return (pi, 0, d.id)
        return (pi, 0, *tuple(c), getattr(d, "core_on_chip", 0))

    try:
        return sorted(devs, key=key)
    except TypeError:
        return devs


def gang_mesh(spec: MeshSpec, annotations: Optional[dict] = None, coordinator: str = "",
              devices: Optional[Sequence[RankDevice]] = None, local_ranks: int = 1,
              backend: str = "", cpu: bool = False) -> Mesh:
    """One mesh for a scheduler-planned gang.  A member of a gang of more
    than one (and no ``devices`` given) first joins the process group
    (``distributed.initialize_for_gang``: its rank from the gang rank, the
    rendezvous at peer 0); the world's ranks are then laid out
    gang-rank-major.  A gang of one, or no gang annotations, builds
    exactly ``make_mesh(spec)``."""
    from .distributed import gang_info_from_annotations, initialize_for_gang

    _rank, size, _peers = gang_info_from_annotations(annotations or {})
    if size > 1 and devices is None:
        initialize_for_gang(annotations or {}, coordinator=coordinator,
                            local_ranks=local_ranks, backend=backend, cpu=cpu)
    if devices is None:
        devices = [RankDevice(d.id, process_index=d.id // max(1, local_ranks))
                   for d in _world_devices()]
    devs = list(devices)
    if size <= 1:
        return make_mesh(spec, devs)
    if len(devs) != spec.num_devices:
        raise ValueError(f"gang mesh spec needs {spec.num_devices} devices, have "
                         f"{len(devs)} across {size} members")
    return _grid(gang_rank_order(devs), spec)


def mesh_from_allocation(annotations: dict, container: str, spec: MeshSpec,
                         devices: Optional[Sequence[RankDevice]] = None) -> Mesh:
    """The job's mesh from its pod's allocation: ranks whose chip
    coordinates match the allocated ones, in allocation order, when the
    ranks carry coordinates; otherwise the first ``spec.num_devices``."""
    alloc = coords_from_annotations(annotations, container)
    devs = list(devices) if devices is not None else _world_devices()
    by_coord = {tuple(d.coords): d for d in devs if getattr(d, "coords", None) is not None}
    chosen = []
    if alloc and by_coord:
        for c in alloc:
            d = by_coord.get(tuple(c))
            if d is None:
                break
            chosen.append(d)
    if len(chosen) != spec.num_devices:
        chosen = devs[:spec.num_devices]
    return make_mesh(spec, chosen)
