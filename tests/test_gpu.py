"""Card-only tests: the device stages on an NVIDIA GPU against the float64
mirror at production widths. Run with ``python -m pytest -m gpu tests/``;
they skip on the CPU."""
import pytest

from nucleoatac_jax.models import selfcheck

pytestmark = pytest.mark.gpu


def test_engine_matches_mirror_at_production_widths(gpu):
    eng = selfcheck.make_engine(core=1024, batch=64)
    mids, sizes, codes = selfcheck.synth_windows(eng, 400, seed=11)
    err = selfcheck.stage_errors(eng, mids, sizes, codes)
    assert err.ll_max < eng.cfg.occ.exact_tol
    assert err.norm_max < eng.cfg.nuc.exact_tol
    assert err.n_certified > 0
    assert err.n_picks_wrong == 0
