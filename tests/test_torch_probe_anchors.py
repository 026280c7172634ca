"""The anchors of ``tools/probe_cg_events.py``'s clock64() stamps against
this tree's kernels, on the CPU (no card, no build): every form of
TRANSPORT_STAMPS and HEAT_STAMPS that this tree's kernels hold has each of
its anchors exactly once in its source, every earlier form (TRANSPORT_EARLIER,
HEAT_EARLIER, which a parent checkout's kernels hold) misses at least one
(so no kernel is stamped twice), and ``check_stamps`` passes for ``--parts
transport,heat``.  An edit of a kernel that moves an anchor fails here, not
on the card."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "devicekmc_tpu_torch" / "csrc"


def _load_probe():
    spec = importlib.util.spec_from_file_location("probe_cg_events",
                                                  ROOT / "tools" / "probe_cg_events.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PROBE = _load_probe()
FORMS = ([("transport", f) for f in PROBE.TRANSPORT_STAMPS]
         + [("heat", f) for f in PROBE.HEAT_STAMPS])


def _anchors(kind, form):
    """(source text, anchors, whether this tree holds the form)."""
    if kind == "transport":
        src = (CSRC / "transport_cg.cu").read_text()
        return src, [a for a, _, _ in PROBE.TRANSPORT_STAMPS[form]], \
            form not in PROBE.TRANSPORT_EARLIER
    src = (CSRC / "heat.cu").read_text()
    return src, [a for a, _, _ in PROBE.HEAT_STAMPS[form][2]], form not in PROBE.HEAT_EARLIER


@pytest.mark.parametrize("kind,form", FORMS, ids=[f"{k}:{f}" for k, f in FORMS])
def test_probe_form_anchors(kind, form):
    src, anchors, held = _anchors(kind, form)
    counts = [src.count(a) for a in anchors]
    if held:
        assert counts == [1] * len(anchors), (form, counts)
    else:
        assert counts != [1] * len(anchors), (form, counts)


def test_probe_check_stamps_passes():
    PROBE.check_stamps(CSRC, {"transport", "heat"})
    src = (CSRC / "transport_cg.cu").read_text()
    held = [f for f in PROBE.TRANSPORT_STAMPS if f not in PROBE.TRANSPORT_EARLIER]
    assert sorted(PROBE.transport_forms(src)) == sorted(held)
    kinds = PROBE.heat_forms((CSRC / "heat.cu").read_text())
    assert sorted(kinds.values()) == sorted(f for f in PROBE.HEAT_STAMPS
                                            if f not in PROBE.HEAT_EARLIER)
