"""The port's mesh entry point (ray_tpu_torch.parallel.mesh's Mesh,
create_mesh, single_device_mesh, group_devices_by_slice,
create_hybrid_mesh and Mesh.join) against the JAX package's twins, on
the cases of test_parallel.py's test_mesh_construction,
test_hybrid_mesh_slice_major_dp and test_hybrid_mesh_rejects_uneven_slices:
the same shape, the same device order mapped by index, the same errors;
and a dp allreduce over the hybrid layout's rank threads against the JAX
shard_map psum's value. The port's ranks are threads of this process
over one HashStore (tests/torch_gang.run_on_mesh), torch at two
intra-op threads, and every group and join has a timeout."""
import jax
import numpy as np
import pytest
import torch

from ray_tpu.parallel import mesh as JM
from ray_tpu_torch.parallel import mesh as M
from ray_tpu_torch.util import collective as col
from tests.test_torch_gpt2_pipelined import two_threads  # noqa: F401
from tests.torch_gang import run_on_mesh

# eight distinct devices to follow by index: a torch.device needs no card
# to be named
DEVICES = [torch.device("cuda", i) for i in range(8)]
# test_mesh_construction's meshes
CONSTRUCTION = [dict(dp=2, sp=2, tp=2), dict(dp=-1, tp=2)]


def _order(jmesh, jdevices):
    """A JAX mesh's devices as indices into the list it was given."""
    ids = [d.id for d in jdevices]
    return [ids.index(d.id) for d in np.asarray(jmesh.devices).flat]


@pytest.mark.parametrize("sizes", CONSTRUCTION)
def test_create_mesh_matches_jax(sizes):
    """create_mesh over eight devices has the JAX mesh's shape (every
    axis, in AXIS_ORDER), axis names, size and device order; rank r's
    device is at flat index r, at coordinates(config, r)."""
    jdevices = jax.devices()[:8]
    jmesh = JM.create_mesh(JM.MeshConfig(**sizes), devices=jdevices)
    mesh = M.create_mesh(M.MeshConfig(**sizes), devices=DEVICES)
    assert list(mesh.shape.items()) == list(jmesh.shape.items())
    assert tuple(mesh.axis_names) == tuple(jmesh.axis_names)
    assert mesh.size == jmesh.size == 8
    assert mesh.devices.shape == np.asarray(jmesh.devices).shape
    assert [d.index for d in mesh.devices.flat] == _order(jmesh, jdevices)
    for r in range(8):
        index = np.unravel_index(r, mesh.devices.shape)
        assert mesh.device(r) == mesh.devices[index]
        assert M.coordinates(mesh.config, r) == tuple(int(i) for i in index)
    assert M.mesh_shape_summary(mesh) == JM.mesh_shape_summary(jmesh)
    for heads, layers in ((4, 2), (3, 2)):
        assert (M.validate_mesh_for_model(mesh, n_heads=heads,
                                          n_layers=layers)
                == JM.validate_mesh_for_model(jmesh, n_heads=heads,
                                              n_layers=layers))


def test_create_mesh_defaults_and_refusals_match_jax():
    """axes= stands for the config, dp takes every device by default, a
    mesh that does not fit the devices raises the JAX twin's error, and
    without a card the default device list raises rather than fall back
    to the CPU."""
    jdevices = jax.devices()[:8]
    for kw in ({}, {"axes": {"tp": 2, "dp": -1}}):
        jmesh = JM.create_mesh(devices=jdevices, **kw)
        mesh = M.create_mesh(devices=DEVICES, **kw)
        assert list(mesh.shape.items()) == list(jmesh.shape.items())
        assert [d.index for d in mesh.devices.flat] == _order(jmesh,
                                                              jdevices)
    for sizes in (dict(dp=3), dict(dp=-1, tp=3)):
        with pytest.raises(ValueError) as jerr:
            JM.create_mesh(JM.MeshConfig(**sizes), devices=jdevices)
        with pytest.raises(ValueError) as err:
            M.create_mesh(M.MeshConfig(**sizes), devices=DEVICES)
        assert str(err.value) == str(jerr.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            M.create_mesh()
        with pytest.raises(RuntimeError, match="devices="):
            M.single_device_mesh()


def test_single_device_mesh_and_slices_match_jax():
    """single_device_mesh is a mesh of one rank on its device, joined
    without a store; group_devices_by_slice puts every device in slice 0,
    as the JAX twin puts CPU devices."""
    jmesh = JM.single_device_mesh(jax.devices()[0])
    mesh = M.single_device_mesh("cpu")
    assert list(mesh.shape.items()) == list(jmesh.shape.items())
    assert mesh.size == 1 and mesh.device(0) == torch.device("cpu")
    lay = mesh.join(0)
    try:
        assert lay.mesh is mesh and lay.device == torch.device("cpu")
        assert lay.world_size == 1
    finally:
        M.destroy_rank_layout(lay)
    jslices = JM.group_devices_by_slice(jax.devices()[:8])
    slices = M.group_devices_by_slice(DEVICES)
    assert list(slices) == list(jslices) == [0]
    assert slices[0] == DEVICES
    with pytest.raises(ValueError, match="store"):
        M.create_mesh(devices=DEVICES).join(0)


def test_hybrid_mesh_slice_major_dp_matches_jax():
    """test_hybrid_mesh_slice_major_dp's mesh: two slices of four devices
    at tp 4, dcn_dp 2: dp 2 x tp 4, each dp row one slice's devices, in
    the JAX twin's order (also with the slices given out of order)."""
    jdevices = jax.devices()[:8]
    for assignments in ([0] * 4 + [1] * 4, [1, 0] * 4):
        jmesh = JM.create_hybrid_mesh(JM.MeshConfig(dp=1, tp=4), dcn_dp=2,
                                      devices=jdevices,
                                      slice_assignments=assignments)
        mesh = M.create_hybrid_mesh(M.MeshConfig(dp=1, tp=4), dcn_dp=2,
                                    devices=DEVICES,
                                    slice_assignments=assignments)
        assert list(mesh.shape.items()) == list(jmesh.shape.items())
        assert dict(mesh.shape) == {"dp": 2, "pp": 1, "ep": 1, "sp": 1,
                                    "tp": 4}
        assert [d.index for d in mesh.devices.flat] == _order(jmesh,
                                                              jdevices)
        assert {d.index for d in mesh.devices[0].ravel()} == {
            i for i, s in enumerate(assignments) if s == 0}
    # one slice, every device within it on tp by default
    jmesh = JM.create_hybrid_mesh(devices=jdevices)
    mesh = M.create_hybrid_mesh(devices=DEVICES)
    assert list(mesh.shape.items()) == list(jmesh.shape.items())


@pytest.mark.parametrize("case", ["uneven", "dcn_dp", "assignments"])
def test_hybrid_mesh_refusals_match_jax(case):
    """test_hybrid_mesh_rejects_uneven_slices's case, a dcn_dp that is not
    the slice count and a slice list of the wrong length: the JAX twin's
    errors, word for word."""
    n, kw = {"uneven": (7, dict(slice_assignments=[0, 0, 0, 0, 1, 1, 1])),
             "dcn_dp": (8, dict(dcn_dp=4, slice_assignments=[0] * 4
                                + [1] * 4)),
             "assignments": (8, dict(slice_assignments=[0] * 7))}[case]
    with pytest.raises(ValueError) as jerr:
        JM.create_hybrid_mesh(devices=jax.devices()[:n], **kw)
    with pytest.raises(ValueError) as err:
        M.create_hybrid_mesh(devices=DEVICES[:n], **kw)
    assert str(err.value) == str(jerr.value)
    if case == "uneven":
        assert "uneven" in str(err.value)


def test_dp_allreduce_over_the_hybrid_layout():
    """On the hybrid mesh's rank threads (joined by Mesh.join), each
    rank's dp block of arange(8) summed over its dp group is
    arange(8).reshape(2, 4).sum(0), as test_hybrid_mesh_slice_major_dp's
    shard_map psum gives; every layout carries the mesh and its device."""
    mesh = M.create_hybrid_mesh(M.MeshConfig(dp=1, tp=4), dcn_dp=2,
                                devices=[torch.device("cpu")] * 8,
                                slice_assignments=[0] * 4 + [1] * 4)
    x = torch.arange(8.0)

    def rank(lay):
        assert lay.mesh is mesh and lay.device == torch.device("cpu")
        block = x[lay.dp_rank * 4:(lay.dp_rank + 1) * 4].clone()
        return lay.rank, col.allreduce(block, lay.dp_group).numpy()

    ranks = run_on_mesh(mesh, rank, name="hybrid")
    assert [r for r, _ in ranks] == list(range(8))
    for _, total in ranks:
        np.testing.assert_array_equal(total,
                                      np.arange(8.0).reshape(2, 4).sum(0))
