"""The port's EM channel, OTA constellation and Eq. 1 precharacterization
(repro_torch.core.em / .ota / .scaleout.precharacterize_state) against the
JAX reference.

Tolerances: the channel matrix is a complex64 einsum whose terms sit near the
cavity's resonant poles (1/(k^2 - k0^2 (1 + j/Q)), Q = 400), summed in another
order than XLA's, so entries agree to ~1e-5 of the largest gain; the tests
allow rtol 1e-4 with an absolute floor of 1e-4 x max|H| for the entries near
zero. The constellations downstream are held to 1e-5 relative. The BERs
are the erfc of those margins: given the same H they agree to 1e-4 relative,
and through the port's own H (1e-5 away) the far tail, where a BER of 1e-5
moves ~2x(margin) times faster than the margin, to 1e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import em as jem, ota as jota, scaleout as jscale
from repro_torch.core import em as tem, ota as tota, scaleout as tscale
from repro_torch import phy as tphy

CPU = "cpu"


def _close_h(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's 3 TX / 64 RX / 7 dB precharacterization (its
    exhaustive search runs once for the module)."""
    return jscale.precharacterize_state(jscale.ScaleOutConfig())


@pytest.mark.parametrize("model", ["cavity", "ray"])
@pytest.mark.parametrize("m,n", [(3, 64), (5, 16), (1, 7)])
def test_channel_matrix_matches_jax(model, m, n):
    geom = jem.PackageGeometry(model=model)
    tgeom = tem.PackageGeometry(model=model)
    np.testing.assert_allclose(tem.tx_positions(tgeom, m, CPU).numpy(),
                               np.asarray(jem.tx_positions(geom, m)), rtol=1e-6)
    np.testing.assert_allclose(tem.rx_positions(tgeom, n, CPU).numpy(),
                               np.asarray(jem.rx_positions(geom, n)), rtol=1e-6)
    h = tem.channel_matrix(tgeom, m, n, CPU)
    assert h.dtype == torch.complex64 and tuple(h.shape) == (n, m)
    _close_h(h, jem.channel_matrix(geom, m, n))


def test_enumeration_helpers_match_jax():
    for m in (1, 3, 5):
        np.testing.assert_array_equal(tota.bit_combos(m).numpy(), np.asarray(jota.bit_combos(m)))
        np.testing.assert_array_equal(tota.majority_labels(m).numpy(),
                                      np.asarray(jota.majority_labels(m)))
    np.testing.assert_array_equal(tota.ordered_phase_pairs().numpy(),
                                  np.asarray(jota.ordered_phase_pairs()))
    np.testing.assert_allclose(tota.phase_codebook().numpy(),
                               np.asarray(jota.phase_codebook()), rtol=1e-7)


@pytest.mark.parametrize("method", ["centroid", "symbol"])
def test_constellations_and_decision_metrics_match_jax(method):
    """Same channel (JAX's H, fed through numpy) and a few phase assignments,
    batched in the port: symbols, BER and validity agree."""
    h = jem.channel_matrix(jem.PackageGeometry(), 3, 64)
    th = torch.from_numpy(np.array(h))
    n0 = jota.default_n0(h, 7.0)
    assert tota.default_n0(th, 7.0) == pytest.approx(n0, rel=1e-6)
    rng = np.random.default_rng(0)
    pairs = np.asarray(jota.ordered_phase_pairs())
    assign = pairs[rng.integers(0, len(pairs), size=(5, 3))]          # [5, 3, 2]
    assign[0] = [[0, 4], [0, 4], [0, 4]]                              # the optimum
    y = tota.rx_constellations(th, torch.from_numpy(assign))          # [5, N, 8]
    maj = jota.majority_labels(3)
    ber, valid = tota.decision_metrics(y, tota.majority_labels(3), n0, method)
    for a in range(len(assign)):
        jy = jota.rx_constellations(h, jnp.asarray(assign[a]))
        np.testing.assert_allclose(y[a].numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5 * float(jnp.abs(jy).max()))
        jb, jv = jota.decision_metrics(jy, maj, n0, method)
        np.testing.assert_array_equal(valid[a].numpy(), np.asarray(jv))
        np.testing.assert_allclose(ber[a].numpy(), np.asarray(jb), rtol=1e-4, atol=1e-7)


def test_exhaustive_search_hits_the_paper_operating_point(jax_state):
    """3 TX / 64 RX / 7 dB: avg BER 0.0100 and max 0.0382 (EXPERIMENTS.md,
    Eq. 1 row), each within 1e-4. The port may pick another phase_idx where
    two assignments score equal up to float32 rounding (the gauge leaves such
    pairs), so the test holds the chosen assignment's mean BER, not its
    indices, to JAX's within 1e-6."""
    st = tscale.precharacterize_state(tscale.ScaleOutConfig(), device=CPU)
    assert abs(float(st.ber.mean()) - 0.0100) < 1e-4
    assert abs(float(st.ber.max()) - 0.0382) < 1e-4
    assert abs(float(st.ber.mean()) - float(jax_state.ber.mean())) < 1e-6
    # the leaves the serve and the symbol tier read, against JAX's
    _close_h(st.h, jax_state.h)
    assert st.n0.item() == pytest.approx(float(jax_state.n0), rel=1e-5)
    np.testing.assert_allclose(st.ber.numpy(), np.asarray(jax_state.ber), rtol=1e-3, atol=1e-7)
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(jax_state.valid))
    for f in ("symbols", "c0", "c1"):
        ref = np.asarray(getattr(jax_state, f))
        np.testing.assert_allclose(getattr(st, f).numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())


def test_coordinate_search_never_beats_the_exhaustive_optimum(jax_state):
    """Coordinate descent (a torch.Generator picks its start) lands on a valid
    assignment whose mean BER is no lower than the exhaustive optimum."""
    h = torch.from_numpy(np.array(jax_state.h))
    n0 = float(jax_state.n0)
    res = tota.optimize_phases_coordinate(h, n0, torch.Generator().manual_seed(0))
    assert tuple(res.phase_idx.shape) == (3, 2)
    assert bool((res.phase_idx[:, 0] != res.phase_idx[:, 1]).all())
    assert float(res.avg_ber) >= float(jax_state.ber.mean()) - 1e-6
    jy = jota.rx_constellations(jnp.asarray(np.asarray(jax_state.h)),
                                jnp.asarray(res.phase_idx.numpy()))
    jb, _ = jota.decision_metrics(jy, jota.majority_labels(3), n0)
    assert float(res.avg_ber) == pytest.approx(float(jnp.mean(jb)), rel=1e-4, abs=1e-7)


def test_snr_and_state_helpers_match_jax(jax_state):
    h = np.array(jax_state.h)
    n0 = float(jax_state.n0)
    np.testing.assert_allclose(tem.snr_per_rx(torch.from_numpy(h), n0).numpy(),
                               np.asarray(jem.snr_per_rx(jnp.asarray(h), n0)),
                               rtol=1e-5, atol=1e-4)
    from repro import phy as jphy
    ber = np.linspace(0.0, 0.3, 8, dtype=np.float32)
    ts = tphy.state_from_ber(torch.from_numpy(ber), 3)
    js = jphy.state_from_ber(jnp.asarray(ber), 3)
    for f in tphy.ChannelState.FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
    bits = np.random.default_rng(1).integers(0, 2, size=(3, 4, 40), dtype=np.uint8)
    np.testing.assert_array_equal(tphy.combo_index(torch.from_numpy(bits)).numpy(),
                                  np.asarray(jphy.combo_index(jnp.asarray(bits))))


def test_symbol_tier_is_not_ported_yet():
    """The symbol tier, once refused here, is registered: it rides the combo
    wire and the config takes it (tests/test_torch_phy.py holds its physics
    against JAX); an unknown tier still raises."""
    assert tphy.get_channel("symbol").wire == "combo"
    assert tscale.ScaleOutConfig(channel="symbol").channel == "symbol"
    with pytest.raises(ValueError, match="unknown channel tier"):
        tphy.get_channel("fading")
