"""``repro_torch.utils.roofline`` against ``repro.utils.roofline``.

  * the wire-byte model of each collective against the reference's
    ``_line_collective`` on one HLO line an op, group sizes 2, 4 and 16;
  * ``Roofline``'s terms, ``as_dict`` and ``bottleneck`` on the same inputs,
    the reference's TPU constants patched to the port's H100 ones, and the
    port's constants the H100 SXM data sheet's;
  * ``from_mesh`` on a census of counted bytes against the reference's
    parse of the same collectives written as HLO lines;
  * ``model_flops``.
"""
import pytest

from repro.utils import roofline as JR
from repro_torch.utils import roofline as R

SHAPE = (1024, 768)
NBYTES = 1024 * 768 * 4


def _line(kind, g, shape=SHAPE):
    """One optimized-HLO line of ``kind`` over groups of ``g`` of 256
    devices, its result f32 of ``shape``."""
    dims = ",".join(str(d) for d in shape)
    return (f"%{kind}.7 = f32[{dims}]{{1,0}} {kind}(f32[{dims}]{{1,0}} %p.3), "
            f"channel_id=3, replica_groups=[{256 // g},{g}]<=[256], dimensions={{0}}")


@pytest.mark.parametrize("kind", R.COLLECTIVES)
@pytest.mark.parametrize("g", [2, 4, 16])
def test_wire_bytes_match_the_reference_line_model(kind, g):
    want_kind, want = JR._line_collective(_line(kind, g), 256)
    assert want_kind == kind
    assert R.wire_bytes(kind, NBYTES, g) == want


def test_unknown_collective_is_refused():
    with pytest.raises(ValueError, match="all-gather"):
        R.wire_bytes("broadcast", NBYTES, 2)


def test_roofline_terms_match_the_reference(monkeypatch):
    """The same terms and bottleneck for compute-, memory- and
    collective-bound inputs once the reference runs on the port's
    constants; the port's constants are the H100's."""
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 450e9)
    monkeypatch.setattr(JR, "PEAK_FLOPS", R.PEAK_FLOPS)
    monkeypatch.setattr(JR, "HBM_BW", R.HBM_BW)
    monkeypatch.setattr(JR, "LINK_BW", R.LINK_BW)
    stats = R.CollectiveStats({"all-gather": 2}, {"all-gather": 3.0e9})
    jstats = JR.CollectiveStats({"all-gather": 2}, {"all-gather": 3.0e9})
    seen = set()
    for flops, hbm, wire in ((1e18, 1e12, 1e9), (1e15, 1e14, 1e9), (1e15, 1e12, 1e12)):
        got = R.Roofline(flops, hbm, wire, 256, stats)
        want = JR.Roofline(flops, hbm, wire, 256, jstats)
        assert got.as_dict() == want.as_dict()
        seen.add(got.bottleneck)
    assert seen == {"compute", "memory", "collective"}
    assert R.Roofline(989e12 * 4, 0.0, 0.0, 4).t_compute == 1.0


def test_from_mesh_counts_wire_bytes_as_the_reference_parses_them():
    """A census of a step's collectives (calls and bytes a rank passed, by
    op and group size, as ``Mesh`` keeps it) gives the counts and wire
    bytes that the reference's HLO parse gives for the same ops."""

    class Counted:
        census = {("all_gather", 4): (3, 3 * 256 * 768 * 4),
                  ("reduce_scatter", 4): (2, 2 * NBYTES * 4),
                  ("all_reduce", 2): (5, 5 * NBYTES),
                  ("ring", 4): (6, 6 * NBYTES)}

    got = R.from_mesh(Counted())
    hlo = "\n".join(["ENTRY %main (p: f32[1]) -> f32[1] {"]
                    + [_line("all-gather", 4)] * 3
                    + [_line("reduce-scatter", 4)] * 2
                    + [_line("all-reduce", 2)] * 5
                    + [_line("collective-permute", 4)] * 6 + ["}"])
    want = JR.parse_collectives(hlo, 256)
    assert got.counts == want.counts
    assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)
    assert got.total_wire_bytes == pytest.approx(want.total_wire_bytes, rel=1e-12)


def test_model_flops_match_the_reference():
    for kw in ({}, {"active_params": 10**9}, {"train": False}):
        assert R.model_flops(7 * 10**9, 4096, **kw) == JR.model_flops(7 * 10**9, 4096, **kw)
