"""Multi-device sharded execution on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from iyokan_tpu import packet as packet_mod
from iyokan_tpu.circuit.blueprint import Blueprint
from iyokan_tpu.engine.driver import Frontend
from iyokan_tpu.parallel import mesh as mesh_mod

from .fixtures import fixture, normalize


@pytest.fixture
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    mesh = mesh_mod.make_mesh(8)
    mesh_mod.set_mesh(mesh)
    yield mesh
    mesh_mod.set_mesh(None)


def test_shard_batch_placement(mesh8):
    """Per-device placement, not just decrypted values: a big batch is
    split 1/8th per device along the gate axis; a tiny level and the
    (key-like) replicated arrays land whole on every device."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    big = jnp.zeros((128, 636), jnp.uint32)
    out = jax.jit(mesh_mod.shard_batch)(big)
    assert out.sharding.is_equivalent_to(
        NamedSharding(mesh8, P("gates", None)), 2)
    shard_shapes = {s.data.shape for s in out.addressable_shards}
    assert shard_shapes == {(16, 636)}
    assert len(out.addressable_shards) == 8

    # below 8 rows/device -> replicated, no ragged shards
    small = jnp.zeros((16, 636), jnp.uint32)
    outs = jax.jit(mesh_mod.shard_batch)(small)
    assert all(s.data.shape == (16, 636) for s in outs.addressable_shards)

    # non-divisible row count -> replicated
    odd = jnp.zeros((129, 636), jnp.uint32)
    outo = jax.jit(mesh_mod.shard_batch)(odd)
    assert all(s.data.shape == (129, 636) for s in outo.addressable_shards)

    # keys: replicated() pins the whole array on every device
    key_like = jnp.zeros((64, 6, 2, 4, 32), jnp.int32)
    outk = jax.jit(mesh_mod.replicated)(key_like)
    assert outk.sharding.is_equivalent_to(NamedSharding(mesh8, P()), 5)

    # batch_sharding mirrors the constraint decisions
    assert mesh_mod.batch_sharding((128, 636)).is_equivalent_to(
        NamedSharding(mesh8, P("gates", None)), 2)
    assert mesh_mod.batch_sharding((16, 636)).is_equivalent_to(
        NamedSharding(mesh8, P()), 2)


def test_level_fn_output_stays_replicated(mesh8, toy_sk, toy_ek):
    """The engine's per-level contract: batches shard, the scattered wire
    state comes back replicated (the all-gather rides the mesh)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from iyokan_tpu.crypto import ops

    keys = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    p = toy_ek.params
    G = 64

    @jax.jit
    def level(keys, pre):
        batch = mesh_mod.shard_batch(pre)
        t1 = ops.gate_bootstrap_tlwe1(batch, keys.bk_for(G), p, keys.backend)
        out = ops.keyswitch_10(t1, keys.ksk_mat, p)
        return mesh_mod.replicated(out)

    pre = jnp.zeros((G, p.n + 1), jnp.uint32)
    out = level(keys, pre)
    assert out.sharding.is_equivalent_to(NamedSharding(mesh8, P()), 2)
    assert out.shape == (G, p.n + 1)


def test_sharded_adder_matches_golden(mesh8, toy_sk, toy_ek):
    req = packet_mod.PlainPacket.from_toml_file(fixture("in/test04.in"))
    bp = Blueprint(fixture("config-toml/addr-4bit.toml"))
    fe = Frontend("tfhe", bp, req.encrypt(toy_sk, seed=5), eval_key=toy_ek)
    fe.go(1)
    got = fe.make_result_packet().decrypt(toy_sk)
    want = packet_mod.PlainPacket.from_toml_file(fixture("out/test04.out"))
    assert normalize(got) == normalize(want)


def test_sharded_ram_cycle(mesh8, toy_sk, toy_ek):
    """CMUX RAM read/write with the write fan-out sharded over the mesh."""
    import os

    req = packet_mod.PlainPacket(
        ram={"ramA": np.zeros(16, np.uint8)},
        bits={
            "addr": np.array([0, 1], np.uint8),
            "wren": np.array([1], np.uint8),
            "wdata": np.array([1, 0, 1, 1], np.uint8),
        },
    )
    bp = Blueprint(os.path.join(os.path.dirname(__file__),
                                "data/tiny-ram.toml"))
    fe = Frontend("tfhe", bp, req.encrypt(toy_sk, seed=6), eval_key=toy_ek)
    fe.go(1)
    res = fe.make_result_packet().decrypt(toy_sk)
    np.testing.assert_array_equal(res.ram["ramA"][2 * 4 : 3 * 4], [1, 0, 1, 1])


def test_tkey_kernel_sharded_over_mesh(mesh8, toy_sk, toy_ek, toy_dk_ntt,
                                       rng):
    """The slab route under an active mesh: GSPMD partitions the step's
    GEMM along the gates axis by itself (no shard_map wrapper), each
    device running its own gate rows against the replicated slab.
    Output must stay sharded on the gates axis and match the NTT route
    bit-exactly."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from iyokan_tpu.crypto import host, ops
    from iyokan_tpu.crypto import polymul as pm

    p = toy_ek.params
    G = 64                        # 8 rows/device = IYOKAN_SHARD_MIN_ROWS
    bits = rng.integers(0, 2, G, dtype=np.uint8)
    ct = jnp.asarray(host.encrypt_bits(toy_sk, bits, rng))
    testv = jnp.full((p.N,), jnp.uint32(p.mu))
    bk_tk = jnp.asarray(pm.tkey_kernel_key(toy_ek.bk, p, limbs=4))

    @jax.jit
    def rot(ct, bk, tv):
        batch = mesh_mod.shard_batch(ct)
        return ops.blind_rotate(batch, bk, tv, p)

    out = rot(ct, bk_tk, testv)
    assert out.sharding.is_equivalent_to(
        NamedSharding(mesh8, P("gates")), 3)
    want = np.asarray(ops.blind_rotate(ct, toy_dk_ntt.bkntt, testv, p,
                                       toy_dk_ntt.backend))
    np.testing.assert_array_equal(np.asarray(out), want)


def test_device_keys_placed_whole_on_mesh(mesh8, toy_ek):
    """Keys built under a mesh are placed whole on every device as they
    are built (one copy per device, none left on the first alone), and
    are cached apart from the keys built without a mesh."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from iyokan_tpu.crypto import ops

    dk = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=True)
    for leaf in jax.tree_util.tree_leaves(dk):
        assert leaf.sharding.is_equivalent_to(
            NamedSharding(mesh8, P()), leaf.ndim)
        assert len(leaf.addressable_shards) == 8
    mesh_mod.set_mesh(None)
    try:
        single = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=True)
    finally:
        mesh_mod.set_mesh(mesh8)
    assert single is not dk
    assert len(single.bkntt.sharding.device_set) == 1


def test_sharded_slab_steps_move_no_data(mesh8, toy_ek):
    """A gates-sharded blind rotation on the slab route compiles to a loop
    with no collective: each device runs its own gates' windows and GEMM
    (the windows stack gate-major along the GEMM's M)."""
    import jax.numpy as jnp

    from iyokan_tpu.crypto import ops

    p = toy_ek.params
    dk = ops.DeviceKeys.from_evalkey(toy_ek, with_cb=False)
    testv = jnp.full((p.N,), jnp.uint32(p.mu))

    @jax.jit
    def rot(ct, bk):
        return ops.blind_rotate(mesh_mod.shard_batch(ct), bk, testv, p)

    ct = jnp.zeros((64, p.n + 1), jnp.uint32)
    hlo = rot.lower(ct, dk.bkntt).compile().as_text()
    assert " dot(" in hlo or "custom-call" in hlo
    for op in ("all-gather", "all-to-all", "collective-permute",
               "all-reduce"):
        assert op not in hlo, op


def test_fused_multi_ram_write_shards_refresh(mesh8, toy_sk, toy_ek):
    """The fused multi-instance RAM write (one SEI->KS->refresh bootstrap
    over the concatenated words of every instance, engine/tfhe.py
    _ram_write_all) under the mesh: the 2 x 2^3 x 4 = 64-row refresh
    batch must SHARD over the gates axis (placement assert, not just a
    value check), and both instances' stores must come back refreshed
    with the written word."""
    import os

    from iyokan_tpu.parallel import mesh as mesh_mod_  # placement oracle

    req = packet_mod.PlainPacket(
        ram={"ramA": np.zeros(32, np.uint8),
             "ramB": np.zeros(32, np.uint8)},
        bits={
            "addr": np.array([0, 1, 0], np.uint8),   # word 2
            "wren": np.array([1], np.uint8),
            "wdata": np.array([1, 0, 1, 1], np.uint8),
            "addrB": np.array([0, 1, 0], np.uint8),
            "wrenB": np.array([1], np.uint8),
            "wdataB": np.array([1, 0, 1, 1], np.uint8),
        },
    )
    bp = Blueprint(os.path.join(os.path.dirname(__file__),
                                "data/tiny-2ram.toml"))
    # the refresh batch [64, N+1] is exactly at the shard threshold
    assert mesh_mod_.batch_sharding((64, 257)).is_equivalent_to(
        jax.sharding.NamedSharding(
            mesh8, jax.sharding.PartitionSpec("gates", None)), 2)

    fe = Frontend("tfhe", bp, req.encrypt(toy_sk, seed=7), eval_key=toy_ek)
    fe.go(1)

    # placement of the LIVE per-instance refreshed stores
    for nm in ("ramA", "ramB"):
        store = fe.rams[nm]                      # [2^a, w, 2, N] device arr
        assert store.shape[0] * store.shape[1] == 32
    res = fe.make_result_packet().decrypt(toy_sk)
    np.testing.assert_array_equal(res.ram["ramA"][2 * 4: 3 * 4],
                                  [1, 0, 1, 1])
    np.testing.assert_array_equal(res.ram["ramB"][2 * 4: 3 * 4],
                                  [1, 0, 1, 1])
