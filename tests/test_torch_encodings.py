"""The port's Section 10 encodings against the reference's on the same
traces: ``encode_trace`` field by field for all four encodings (the LUT
through the byte-LUT kernel's plain version on the CPU), the refresh
deadline after the LUT latency, the offline BDI encoder, and
``encoding_energy_study`` through the committed quick-fit model at
rtol 1e-5."""
import pathlib

import numpy as np
import pytest
import torch

from repro.core import encodings as renc
from repro.core import model_api as rma
from repro.core import traces as rtraces
from repro_torch.core import dram as pdram
from repro_torch.core import encodings as penc
from repro_torch.core import model_api as pma
from repro_torch.core import traces as ptraces
from repro_torch.kernels.byte_lut import byte_lut as p_lut

MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")
APPS = (0, 7, 12)          # perlbench (ascii), libquantum (zeros), xalancbmk
T = pdram.TIMING


def _assert_trace_equal(ref, port):
    for name, r, p in zip(ref._fields, ref, port):
        r = np.asarray(r)
        p = p.numpy()
        if name == "data":
            p = p.view(np.uint32)
        np.testing.assert_array_equal(p, r, err_msg=name)


@pytest.fixture(scope="module")
def app_traces():
    return {i: (rtraces.app_trace(rtraces.SPEC_APPS[i], n_requests=400),
                ptraces.app_trace(ptraces.SPEC_APPS[i], n_requests=400))
            for i in APPS}


@pytest.mark.parametrize("encoding", renc.ENCODINGS)
@pytest.mark.parametrize("app", APPS)
def test_encode_trace_matches_reference_field_by_field(app_traces, app,
                                                       encoding):
    ref_tr, port_tr = app_traces[app]
    _assert_trace_equal(ref_tr, port_tr)
    before = p_lut.apply_lut_lines.launches
    _assert_trace_equal(renc.encode_trace(ref_tr, encoding),
                        penc.encode_trace(port_tr, encoding, device="cpu"))
    assert p_lut.apply_lut_lines.launches == before      # CPU: plain
    raw = penc.encode_trace(port_tr, encoding, conform_refresh=False,
                            device="cpu")
    _assert_trace_equal(renc.encode_trace(ref_tr, encoding,
                                          conform_refresh=False), raw)


def test_encode_trace_conforms_refresh_deadline():
    """The LUT latency must not push the scheduled refreshes past tREFI;
    the port's rescheduling matches the reference's."""
    ref_tr = rtraces.app_trace(rtraces.SPEC_APPS[7], n_requests=3000)
    tr = ptraces.app_trace(ptraces.SPEC_APPS[7], n_requests=3000)
    raw = penc.encode_trace(tr, "owi", conform_refresh=False, device="cpu")
    fixed = penc.encode_trace(tr, "owi", device="cpu")
    slack = 2 * max(T.tBURST + 1, T.tRCD + T.tRP)
    assert ptraces.refresh_deadline_overshoot(raw) > \
        ptraces.refresh_deadline_overshoot(tr) + 64
    assert ptraces.refresh_deadline_overshoot(fixed) <= \
        ptraces.refresh_deadline_overshoot(tr) + slack
    total = int(fixed.dt.to(torch.int64).sum())
    n_ref = int((fixed.cmd == pdram.REF).sum())
    assert n_ref >= 0.8 * total / (T.tREFI + T.tRP + T.tRFC)
    ref_raw = renc.encode_trace(ref_tr, "owi", conform_refresh=False)
    for r, p in ((ref_tr, tr), (ref_raw, raw)):
        assert ptraces.refresh_deadline_overshoot(p) == \
            rtraces.refresh_deadline_overshoot(r)
    _assert_trace_equal(rtraces.reschedule_refresh(ref_raw),
                        ptraces.reschedule_refresh(raw))
    np.testing.assert_array_equal(ptraces.trace_request_lines(fixed),
                                  rtraces.trace_request_lines(
                                      rtraces.reschedule_refresh(ref_raw)))


def test_lines_from_bytes_matches_reference():
    rng = np.random.default_rng(61)
    buf = rng.integers(0, 256, size=1000, dtype=np.uint8)
    np.testing.assert_array_equal(ptraces.lines_from_bytes(buf),
                                  rtraces.lines_from_bytes(buf))
    np.testing.assert_array_equal(ptraces.lines_from_bytes(buf.tobytes()),
                                  rtraces.lines_from_bytes(buf.tobytes()))


def test_host_encoders_match_reference():
    rng = np.random.default_rng(67)
    lines = rng.integers(0, 1 << 32, size=(50, 16),
                         dtype=np.uint64).astype(np.uint32)
    lines[:20] &= np.uint32(0x00FF00FF)
    np.testing.assert_array_equal(penc.popcount_sorted_codes(),
                                  renc.popcount_sorted_codes())
    hist = penc.byte_histogram(torch.from_numpy(lines.view(np.int32)))
    np.testing.assert_array_equal(hist, renc.byte_histogram(lines))
    lut = penc.optimized_lut(hist)
    np.testing.assert_array_equal(lut, renc.optimized_lut(hist))
    np.testing.assert_array_equal(penc.apply_lut(lines, lut),
                                  renc.apply_lut(lines, lut))
    np.testing.assert_array_equal(penc.invert_lines(lines),
                                  renc.invert_lines(lines))
    np.testing.assert_array_equal(
        penc.bytes_to_words(penc.words_to_bytes(lines)), lines)
    for a, b in zip(penc.bdi_encode_lines(lines),
                    renc.bdi_encode_lines(lines)):
        np.testing.assert_array_equal(a, b)


def test_lut_encodings_need_the_card_unless_asked(app_traces, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_tr = app_traces[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        penc.encode_trace(port_tr, "optimized")
    assert penc.encode_trace(port_tr, "baseline") is port_tr
    penc.encode_trace(port_tr, "bdi")           # host encoder: no device


def test_encoding_energy_study_matches_reference(app_traces):
    r_model = rma.load_estimator(str(MODEL))
    p_model = pma.load_estimator(str(MODEL), device="cpu")
    names = [rtraces.SPEC_APPS[i].name for i in APPS]
    want = renc.encoding_energy_study(
        {n: app_traces[i][0] for n, i in zip(names, APPS)}, r_model)
    got = penc.encoding_energy_study(
        {n: app_traces[i][1] for n, i in zip(names, APPS)}, p_model)
    assert list(got) == names
    for name in names:
        assert list(got[name]) == list(penc.ENCODINGS)
        np.testing.assert_allclose(
            [got[name][e] for e in penc.ENCODINGS],
            [want[name][e] for e in renc.ENCODINGS], rtol=1e-5)
    sub = penc.encoding_energy_study(
        {names[0]: app_traces[APPS[0]][1]}, p_model, vendors=[0])
    want_sub = renc.encoding_energy_study(
        {names[0]: app_traces[APPS[0]][0]}, r_model, vendors=[0])
    np.testing.assert_allclose(list(sub[names[0]].values()),
                               list(want_sub[names[0]].values()), rtol=1e-5)
