"""Sharding tests on the 8-device virtual CPU mesh + graft entry points."""
import numpy as np


def test_dryrun_multichip_8():
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_entry_compiles_and_runs():
    import jax

    from __graft_entry__ import entry

    fn, args = entry()
    out = jax.jit(fn)(*args)
    occ, nuc = out
    assert np.isfinite(np.asarray(occ.occ)).all()
    assert np.isfinite(np.asarray(nuc.norm)).all()


def test_sharded_matches_single_device(rng):
    import jax.numpy as jnp

    from __graft_entry__ import _example_args, _tiny_engine
    from nucleoatac_jax.parallel import make_mesh, sharded_full_step, sharded_size_histogram

    cfg, engine = _tiny_engine(batch=8)
    mids, sizes, valid, logb = _example_args(cfg, engine, batch=8)
    mesh = make_mesh(8)
    occ_s, nuc_s = sharded_full_step(engine, mesh)(mids, sizes, valid, logb)
    occ_1, nuc_1 = engine.full_step_frags(
        jnp.asarray(mids), jnp.asarray(sizes), jnp.asarray(valid), jnp.asarray(logb)
    )
    np.testing.assert_allclose(np.asarray(occ_s.occ), np.asarray(occ_1.occ), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(nuc_s.norm), np.asarray(nuc_1.norm), rtol=1e-4, atol=1e-4
    )
    # psum histogram == plain bincount
    hist = np.asarray(sharded_size_histogram(mesh, 0, 251)(sizes, valid))
    ref = np.bincount(sizes[(sizes >= 0) & (sizes < 251)], minlength=251)[:251]
    np.testing.assert_allclose(hist, ref)


def test_mesh_engine_matches_unsharded_packed_seq(rng):
    """DeviceEngine(mesh=...) with in/out shardings produces the same
    tracks as the single-device engine on the packed+seq wire format
    (the auto_mesh path run_pipeline takes when >1 device is visible)."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _tiny_engine
    from nucleoatac_jax.models.data import pack_fragments
    from nucleoatac_jax.parallel import make_mesh

    mesh = make_mesh(8)
    cfg, eng_mesh = _tiny_engine(batch=8, mesh=mesh)
    _, eng_one = _tiny_engine(batch=8)
    B, F, W = 8, 128, eng_one.width
    mids = rng.integers(0, W, size=(B, F)).astype(np.int32)
    sizes = rng.integers(20, 250, size=(B, F)).astype(np.int32)
    packed = np.zeros((B, F), np.int32)
    for b in range(B):
        pack_fragments(mids[b], sizes[b], packed, b)
    codes = rng.integers(0, 5, size=(B, eng_one.seq_codes_width())).astype(np.uint8)
    o_m = eng_mesh.full_step_packed_seq(jnp.asarray(packed), jnp.asarray(codes))
    o_1 = eng_one.full_step_packed_seq(jnp.asarray(packed), jnp.asarray(codes))
    for a, b in zip(jax.tree.leaves(o_m), jax.tree.leaves(o_1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_auto_mesh_selection():
    from nucleoatac_jax.config import RunConfig, WindowParams
    from nucleoatac_jax.models.pipeline import auto_mesh

    assert auto_mesh(RunConfig(window=WindowParams(batch=8))) is not None  # 8 % 8 == 0
    assert auto_mesh(RunConfig(window=WindowParams(batch=9))) is None
