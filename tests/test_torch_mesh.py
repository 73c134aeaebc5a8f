"""The port's mesh layouts against the reference's, with no processes.

A port mesh is a grid of rank ids (``parallel/mesh.Mesh.ranks``); the
reference's is a grid of JAX devices.  On the 8-device virtual CPU mesh a
device's id is the rank that stands in its place, so the two grids, and
every axis group cut from them, must be equal: ``make_mesh``,
``mesh_from_allocation``, ``hierarchical_mesh``, ``gang_mesh`` and the pure
ordering helpers, on devices without coordinates (the CPU's) and on
stand-ins that carry coordinates, process indices and slice indices.
"""

import numpy as np
import pytest

import jax

from elastic_gpu_scheduler_tpu.parallel import mesh as jmesh
from elastic_gpu_scheduler_tpu.parallel.distributed import (
    gang_info_from_annotations as jax_gang_info,
)
from elastic_gpu_scheduler_tpu.utils import consts
from elastic_gpu_scheduler_tpu_torch import launcher
from elastic_gpu_scheduler_tpu_torch.parallel import distributed as pdist
from elastic_gpu_scheduler_tpu_torch.parallel import mesh as pmesh
from elastic_gpu_scheduler_tpu_torch.parallel.mesh import MeshSpec, RankDevice

SPECS = [
    dict(data=8), dict(fsdp=8), dict(data=2, tensor=4), dict(data=2, fsdp=2, tensor=2),
    dict(tensor=2, seq=4), dict(data=2, seq=2, tensor=2), dict(fsdp=2, pipe=2, tensor=2),
    dict(expert=2, fsdp=2, seq=2), dict(data=4), dict(tensor=2, seq=2),
]
GROUPS = [("data",), ("fsdp",), ("tensor",), ("seq",), ("data", "fsdp"),
          ("data", "fsdp", "seq"), pmesh.AXES]


def _ids(jm) -> np.ndarray:
    return np.vectorize(lambda d: d.id)(jm.devices)


def _ref_groups(ids: np.ndarray, axes) -> set:
    """Axis groups of a reference device grid, ordered along ``axes``."""
    idx = [pmesh.AXES.index(a) for a in axes]
    rest = [i for i in range(len(pmesh.AXES)) if i not in idx]
    moved = np.transpose(ids, rest + idx)
    return {tuple(int(x) for x in g) for g in moved.reshape(-1, int(np.prod([ids.shape[i] for i in idx])))}


def _port_groups(m, axes) -> set:
    return {tuple(g) for g in m.all_groups(axes)}


def _same_layout(pm, jm):
    ids = _ids(jm)
    np.testing.assert_array_equal(pm.ranks, ids)
    assert pm.axis_names == tuple(jm.axis_names)
    for axes in GROUPS:
        assert _port_groups(pm, axes) == _ref_groups(ids, axes), axes


def _ranks(n):
    return [RankDevice(i) for i in range(n)]


def test_mesh_spec_matches_reference():
    for kw in SPECS:
        a, b = MeshSpec(**kw), jmesh.MeshSpec(**kw)
        assert a.sizes == b.sizes and a.num_devices == b.num_devices
    for args in [(8,), (8, 2), (8, 2, 2), (8, 2, 1, 2), (16, 4, 1, 2)]:
        assert MeshSpec.for_devices(*args).sizes == jmesh.MeshSpec.for_devices(*args).sizes
    for bad in [(8, 3), (8, 2, 1, 3)]:
        with pytest.raises(ValueError):
            MeshSpec.for_devices(*bad)
        with pytest.raises(ValueError):
            jmesh.MeshSpec.for_devices(*bad)


def test_mesh_flag_parses_like_reference():
    assert pmesh.parse_mesh("tensor=2,seq=2").sizes == jmesh.MeshSpec(tensor=2, seq=2).sizes
    assert pmesh.parse_mesh("data=4").num_devices == 4
    for bad in ["bogus=2", "tensor=x", "tensor=0"]:
        with pytest.raises(ValueError):
            pmesh.parse_mesh(bad)


@pytest.mark.parametrize("kw", SPECS, ids=str)
def test_make_mesh_matches_reference(kw):
    spec = MeshSpec(**kw)
    n = spec.num_devices
    _same_layout(pmesh.make_mesh(spec, _ranks(n)),
                 jmesh.make_mesh(jmesh.MeshSpec(**kw), jax.devices()[:n]))


def test_mesh_from_allocation_matches_reference():
    ann = {consts.ANNOTATION_CONTAINER_PREFIX + "main": "0.0.0,0.1.0,1.0.0,1.1.0"}
    for kw in [dict(data=2, tensor=2), dict(seq=4), dict(fsdp=2, tensor=2)]:
        jm = jmesh.mesh_from_allocation(ann, "main", jmesh.MeshSpec(**kw))
        pm = pmesh.mesh_from_allocation(ann, "main", MeshSpec(**kw), _ranks(8))
        _same_layout(pm, jm)
    assert pmesh.coords_from_annotations(ann, "main") == jmesh.coords_from_annotations(ann, "main")
    # ranks that carry chip coordinates: the allocated ones, in coordinate order
    devs = [RankDevice(i, coords=(i % 2, i // 2, 0)) for i in range(8)]
    m = pmesh.mesh_from_allocation(ann, "main", MeshSpec(data=2, tensor=2), devs)
    by_coord = {d.coords: d.id for d in devs}
    want = [by_coord[c] for c in sorted([(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)])]
    assert m.ranks.reshape(-1).tolist() == want


class _Dev:
    """A stand-in for a JAX device: the attributes the reference's pure
    ordering helpers read."""

    def __init__(self, i, pi=0, coords=None, si=None):
        self.id, self.process_index, self.coords, self.slice_index = i, pi, coords, si
        self.core_on_chip = 0


def _both(n, **attrs):
    """Reference stand-ins and port ranks with the same attributes."""
    refs, ports = [], []
    for i in range(n):
        a = {k: f(i) for k, f in attrs.items()}
        refs.append(_Dev(i, a.get("pi", 0), a.get("coords"), a.get("si")))
        ports.append(RankDevice(i, a.get("pi", 0), a.get("coords"), a.get("si")))
    return refs, ports


def test_ordering_helpers_match_reference():
    perm = [5, 2, 7, 0, 3, 6, 1, 4]
    refs, ports = _both(8, pi=lambda i: (i * 3) % 4, coords=lambda i: (i % 2, (i * 5) % 8 // 2))
    refs, ports = [refs[i] for i in perm], [ports[i] for i in perm]
    assert [d.id for d in jmesh._ici_order(refs)] == [d.id for d in pmesh._ici_order(ports)]
    assert ([d.id for d in jmesh.gang_rank_order(refs)]
            == [d.id for d in pmesh.gang_rank_order(ports)])
    refs, ports = _both(8, si=lambda i: 1 - i // 4, coords=lambda i: (i % 4,))
    refs, ports = [refs[i] for i in perm], [ports[i] for i in perm]
    assert ([[d.id for d in g] for g in jmesh._slice_partition(refs, 2)]
            == [[d.id for d in g] for g in pmesh._slice_partition(ports, 2)])
    with pytest.raises(ValueError, match="hardware slices"):
        pmesh._slice_partition(ports, 4)


@pytest.mark.parametrize("kw", [dict(data=2, fsdp=2, tensor=2), dict(data=2, seq=2, tensor=2),
                                dict(data=4, tensor=2)], ids=str)
def test_hierarchical_mesh_matches_reference(kw):
    jm = jmesh.hierarchical_mesh(jmesh.MeshSpec(**kw), 2, devices=jax.devices()[:8])
    pm = pmesh.hierarchical_mesh(MeshSpec(**kw), 2, _ranks(8))
    _same_layout(pm, jm)
    # the data axis spans the slices; every other axis stays inside one
    per_slice = 4
    crosses, intra = pmesh.classify_replica_groups(pm.all_groups("data"), per_slice)
    assert crosses and not intra
    for g in crosses:  # a pair across the two slices: the same position in each
        if len(g) == 2:
            assert len({r % per_slice for r in g}) == 1 and len({r // per_slice for r in g}) == 2
    for axes in [("fsdp",), ("tensor",), ("seq",)]:
        if pm.axes_size(axes) > 1:
            crosses, intra = pmesh.classify_replica_groups(pm.all_groups(axes), per_slice)
            assert intra and not crosses, axes
    with pytest.raises(ValueError, match="divisible"):
        pmesh.hierarchical_mesh(MeshSpec(data=1, fsdp=8), 2, _ranks(8))


def test_ring_hops_stay_inside_a_slice():
    """The ring's edges (rank i → i + 1 along ``seq``) of the hierarchical
    mesh stay in one slice, as the reference's collective-permute pairs do."""
    pm = pmesh.hierarchical_mesh(MeshSpec(data=2, seq=2, tensor=2), 2, _ranks(8))
    edges = [(g[i], g[(i + 1) % len(g)]) for g in pm.all_groups("seq") for i in range(len(g))]
    assert edges and all(a // 4 == b // 4 for a, b in edges)
    # HLO-style text parses the reference's way
    txt = "all-reduce(x), replica_groups={{0,4},{1,5}} foo replica_groups={{0,1},{2,3}}"
    assert (pmesh.classify_replica_groups(txt, 4)
            == jmesh.classify_replica_groups(txt, 4))


def test_gang_mesh_matches_reference():
    ann = {consts.ANNOTATION_GANG_RANK: "1",
           consts.ANNOTATION_GANG_PEERS: "ns/m-0,ns/m-1"}
    spec = dict(data=4, tensor=2)
    # gang of two, devices given: no process group is joined
    jm = jmesh.gang_mesh(jmesh.MeshSpec(**spec), ann, devices=jax.devices()[:8])
    ports = [RankDevice(i, process_index=i // 4) for i in range(8)]
    pm = pmesh.gang_mesh(MeshSpec(**spec), ann, devices=ports)
    _same_layout(pm, jm)
    # a gang of one, or no annotations, is make_mesh
    solo = {consts.ANNOTATION_GANG_RANK: "0", consts.ANNOTATION_GANG_PEERS: "ns/solo-0"}
    base = pmesh.make_mesh(MeshSpec(fsdp=8), _ranks(8))
    for a in (solo, {}):
        np.testing.assert_array_equal(pmesh.gang_mesh(MeshSpec(fsdp=8), a, devices=_ranks(8)).ranks,
                                      base.ranks)
    with pytest.raises(ValueError, match="gang mesh spec"):
        pmesh.gang_mesh(MeshSpec(data=2), ann, devices=ports)


def test_gang_info_matches_reference():
    cases = [
        {consts.ANNOTATION_GANG_RANK: "3", consts.ANNOTATION_GANG_PEERS: "ns/a,ns/b,ns/c,ns/d"},
        {consts.ANNOTATION_GANG_SIZE: "6"},
        {},
        {consts.ANNOTATION_GANG_RANK: "x", consts.ANNOTATION_GANG_PEERS: "ns/a"},
    ]
    for ann in cases:
        assert pdist.gang_info_from_annotations(ann) == jax_gang_info(ann)
    assert pmesh.gang_slices_from_annotations(
        {consts.ANNOTATION_GANG_SLICES: "a,b,"}) == jmesh.gang_slices_from_annotations(
        {consts.ANNOTATION_GANG_SLICES: "a,b,"})
    # the port's annotation names are the reference's
    for name in ("ANNOTATION_CONTAINER_PREFIX", "ANNOTATION_GANG_SIZE", "ANNOTATION_GANG_SLICES",
                 "ANNOTATION_GANG_RANK", "ANNOTATION_GANG_PEERS"):
        assert getattr(pmesh, name) == getattr(consts, name)


def test_gang_of_one_and_single_process_join_nothing():
    assert pdist.initialize_for_gang({}) is False
    assert pdist.maybe_initialize_distributed() is False
    assert pdist.process_info() == (0, 1)
    with pytest.raises(ValueError, match="coordinator"):
        pdist.initialize_for_gang({consts.ANNOTATION_GANG_SIZE: "2"})


def test_backend_is_chosen_by_name():
    assert pdist.resolve_backend("", 4, cpu=True) == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        pdist.resolve_backend("nccl", 2, cpu=True)
    # more ranks than cards: NCCL is refused, gloo named explicitly is not
    with pytest.raises(ValueError, match="--dist-backend gloo"):
        pdist.resolve_backend("", 2, cpu=False)
    assert pdist.resolve_backend("gloo", 2, cpu=False) == "gloo"
    with pytest.raises(ValueError):
        pdist.resolve_backend("mpi", 1, cpu=True)


def test_mesh_groups_need_a_process_group():
    m = pmesh.make_mesh(MeshSpec(tensor=2), _ranks(2))
    with pytest.raises(RuntimeError, match="not connected"):
        m.group("tensor")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        m.connect()
    one = pmesh.make_mesh(MeshSpec(), _ranks(1)).connect()
    assert one.group("tensor") is None and one.rank == 0


def test_launcher_builds_the_reference_mesh():
    """The launcher's choice: hierarchical when a gang straddles slices and
    the data axis holds the boundary, else the flat mesh from the
    allocation (with the reference's warning)."""
    ann = {consts.ANNOTATION_GANG_SLICES: "a,b"}
    job = launcher.JobSpec(mesh=MeshSpec(data=2, tensor=2))
    m = launcher.build_mesh(job, ann, "main", _ranks(4))
    jm = jmesh.hierarchical_mesh(jmesh.MeshSpec(data=2, tensor=2), 2, jax.devices()[:4])
    np.testing.assert_array_equal(m.ranks, _ids(jm))
    flat = launcher.build_mesh(launcher.JobSpec(mesh=MeshSpec(fsdp=4)), ann, "main", _ranks(4))
    np.testing.assert_array_equal(flat.ranks,
                                  _ids(jmesh.make_mesh(jmesh.MeshSpec(fsdp=4), jax.devices()[:4])))
