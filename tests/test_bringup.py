"""The GPU bring-up contract, checked on the CPU: conv precision, the
compile-cache placement, chip_smoke.py's device guard and last line, the
removed conv modes, the native-library loader and the f64 self-check."""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _eqns(jaxpr):
    """Every equation of a closed jaxpr, sub-jaxprs (pjit, scan) included."""
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    yield from _eqns(getattr(inner, "jaxpr", inner))


@pytest.mark.parametrize("conv", ["diag", "direct"])
def test_conv_stage_runs_every_product_at_conv_precision(conv):
    """Every dot_general / conv in the nuc conv stage carries
    ops/xcorr.py :: CONV_PRECISION (HIGHEST: full f32 products; a GPU's
    default lets f32 matmuls run in TF32)."""
    from nucleoatac_jax.models.selfcheck import make_engine
    from nucleoatac_jax.ops.xcorr import CONV_PRECISION

    assert CONV_PRECISION == jax.lax.Precision.HIGHEST
    eng = make_engine(core=256, batch=2, conv=conv)
    S = eng.cfg.sizes.upper - eng.cfg.sizes.lower
    Sv = eng.cfg.vmat.upper - eng.cfg.vmat.lower
    mat = jax.ShapeDtypeStruct((2, S, eng.width), np.float32)
    b0 = jax.ShapeDtypeStruct((2, Sv, eng.width), np.float32)
    jaxpr = jax.make_jaxpr(eng._convs_impl)(mat, b0)
    products = [e for e in _eqns(jaxpr.jaxpr)
                if e.primitive.name in ("dot_general", "conv_general_dilated")]
    assert products
    for e in products:
        assert e.params["precision"] == (CONV_PRECISION, CONV_PRECISION), e


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only cache directory;
    otherwise the cache is <repo>/.jax_cache."""
    script = (
        "import jax, jax.numpy as jnp\n"
        "from nucleoatac_jax.utils.compile_cache import "
        "DEFAULT_CACHE_DIR, enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3.0 + 0.125)(jnp.ones(7)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "print(DEFAULT_CACHE_DIR)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, check=True,
        capture_output=True, text=True,
    ).stdout.split()
    used, default = out[-2], out[-1]
    assert default == os.path.join(REPO, ".jax_cache")
    if env_dir:
        assert used == str(tmp_path / "cc")
        assert os.listdir(used), "no cache entry in JAX_COMPILATION_CACHE_DIR"
    else:
        assert used == default


def test_chip_smoke_device_guard_refuses_the_cpu():
    import chip_smoke

    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.require_gpu(jax.default_backend(), jax.devices())
    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.require_gpu("cpu", [gpu])
    chip_smoke.require_gpu("gpu", [gpu])


def test_chip_smoke_last_line_has_exactly_the_contract_keys():
    import chip_smoke

    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = json.loads(chip_smoke.result_line([gpu] * 4))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_chip_smoke_fails_without_a_result_on_the_cpu():
    """`python chip_smoke.py` on a machine without a card: non-zero
    exit, and no JSON result line."""
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_only_the_xla_conv_modes_remain():
    """--conv offers diag and direct only, the engine refuses any other
    conv mode, and it takes no kernel-selection flag."""
    import inspect

    from nucleoatac_jax.cli.nucleoatac import nucleoatac_parser
    from nucleoatac_jax.models.engine import DeviceEngine
    from nucleoatac_jax.models.selfcheck import make_engine

    run = nucleoatac_parser()._subparsers._group_actions[0].choices["run"]
    conv = next(a for a in run._actions if a.dest == "conv")
    assert conv.choices == ["diag", "direct"]
    base = ["run", "--bam", "x.bam", "--bed", "x.bed", "--out", "o"]
    with pytest.raises(SystemExit):
        nucleoatac_parser().parse_args(base + ["--conv", "fused"])
    with pytest.raises(ValueError, match="conv_mode"):
        make_engine(core=256, batch=2, conv="fused")
    assert list(inspect.signature(DeviceEngine).parameters) == [
        "cfg", "mix", "fragmentsizes", "vmat", "mesh", "pwm", "conv_mode"]


def test_native_loader_warns_once_and_returns_none(tmp_path, monkeypatch, caplog):
    """A library that cannot be built gives None and one warning naming
    it; callers then take their numpy fallback."""
    from nucleoatac_jax.io import native

    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))  # no Makefile
    native.load.cache_clear()
    try:
        with caplog.at_level("WARNING", logger="nucleoatac"):
            assert native.load("nucio") is None
            assert native.load("nucio") is None
    finally:
        native.load.cache_clear()
    warnings = [r for r in caplog.records if "libnucio.so" in r.getMessage()]
    assert len(warnings) == 1


def test_native_build_rebuilds_a_library_whose_source_changed(
    tmp_path, monkeypatch
):
    """build() runs make every time, so an edited source never leaves a
    stale library in use."""
    from nucleoatac_jax.io import native

    (tmp_path / "Makefile").write_text("libdemo.so: demo.cpp\n\tcp demo.cpp $@\n")
    src = tmp_path / "demo.cpp"
    src.write_text("one")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    lib = native.build("demo")
    assert open(lib).read() == "one"
    src.write_text("two")
    os.utime(src, (os.path.getmtime(lib) + 5,) * 2)
    assert open(native.build("demo")).read() == "two"


def test_occ_stage_returns_the_ll_it_certified_on():
    """occupancy_packed2(return_ll=True): the same bytes as the production
    call, plus the core slice of the LL surface they were decided on."""
    import jax.numpy as jnp

    from nucleoatac_jax.models import selfcheck
    from nucleoatac_jax.ops.occupancy import _ll_and_n

    eng = selfcheck.make_engine(core=256, batch=2)
    mids, sizes, _ = selfcheck.synth_windows(eng, 200, seed=3)
    mat = selfcheck.raster(eng, mids, sizes)
    packed, ll = eng._occ_packed2_impl(mat, return_ll=True)
    np.testing.assert_array_equal(packed, eng._occ_packed2(mat))
    full = _ll_and_n(mat.astype(jnp.float32), eng.log_mix, eng.cfg.occ.flank)[0]
    np.testing.assert_allclose(
        ll, full[:, eng.core_lo : eng.core_lo + eng.core], rtol=1e-6, atol=1e-5
    )


@pytest.mark.parametrize("conv", ["diag", "direct"])
def test_selfcheck_stages_match_the_mirror_on_cpu(conv):
    """models/selfcheck.py (chip_smoke phase b) at a small width: every
    stage within exact_tol of the f64 mirror, certified picks equal."""
    from nucleoatac_jax.models import selfcheck

    eng = selfcheck.make_engine(core=256, batch=2, conv=conv)
    mids, sizes, codes = selfcheck.synth_windows(eng, 200, seed=5)
    err = selfcheck.stage_errors(eng, mids, sizes, codes)
    assert err.ll_max < eng.cfg.occ.exact_tol / 4
    assert err.norm_max < eng.cfg.nuc.exact_tol / 4
    assert err.n_certified > 0
    assert err.n_picks_wrong == 0
