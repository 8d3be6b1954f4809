"""``trace.reduce_trace`` on a small Chrome trace written by hand: the
keys it has always returned, the program's ranges found by their prefix,
and the collectives' union and its exposed part, against values worked
by hand; and ``trace.merge`` of two ranks' reductions."""

import json

import pytest

from chipbench import trace

US = 1e-6


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 5, "tid": 1, "args": {"correlation": corr}}


def _device(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "args": {"correlation": corr, "stream": 7}}


EVENTS = [
    _range(trace.STRETCH, 0, 1000),
    _range("chipbench.local_sgd", 100, 300),
    _range("repro_torch.local_sgd", 110, 200),
    _range("repro_torch.local_sgd", 500, 100),
    _range("repro_torch.plan", 700, 50),
    _range("repro_torch.stage", 700, 50, tid=2),    # another thread
    _range("other.range", 100, 50),                 # not the prefix
    _launch(1, 120), _launch(2, 130), _launch(5, 140), _launch(3, 510),
    _launch(4, 800),
    _device("gemm", 1, 200, 100),                              # 200-300
    _device("ncclDevKernel_AllReduce_Sum_bf16_RING_LL", 2, 250, 150),
    _device("Memcpy HtoD (Pageable -> Device)", 5, 150, 20,
            cat="gpu_memcpy"),                                 # 150-170
    _device("elementwise", 3, 520, 50),                        # 520-570
    _device("ncclDevKernel_AllGather_RING_LL", 4, 810, 40),    # 810-850
]


@pytest.fixture
def reduced(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return trace.reduce_trace(str(path), ["chipbench.local_sgd",
                                          "chipbench.mix_update"])


def test_the_keys_it_always_returned(reduced):
    r = reduced
    assert r["window_s"] == pytest.approx(1000 * US)
    # busy: 150-170, 200-400, 520-570, 810-850
    assert r["busy_s"] == pytest.approx(310 * US)
    assert r["device_sum_s"] == pytest.approx(360 * US)
    assert r["n_device_events"] == 5 and r["unlaunched"] == 0
    # launched under chipbench.local_sgd (100-400): 1, 2, 5
    assert r["span_device_s"]["chipbench.local_sgd"] == pytest.approx(
        220 * US)
    assert r["span_device_s"]["chipbench.mix_update"] == 0
    assert r["span_count"] == {"chipbench.local_sgd": 1,
                               "chipbench.mix_update": 0}
    assert r["h2d_s"] == pytest.approx(20 * US)
    assert r["streams"] == {"7": [5, pytest.approx(360 * US)]}
    assert r["device_ops"][0] == ["ncclDevKernel_AllReduce_Sum_bf16_RING_LL",
                                  pytest.approx(150 * US)]
    # idle: 0-150, 170-200, 400-520, 570-810, 850-1000
    assert sum(v for _, v in r["idle_gaps"]) == pytest.approx(690 * US)


def test_the_programs_ranges_by_their_prefix(reduced):
    spans = reduced["program_spans"]
    assert set(spans) == {"repro_torch.local_sgd", "repro_torch.plan"}
    sgd = spans["repro_torch.local_sgd"]
    assert sgd["count"] == 2
    assert sgd["host_s"] == pytest.approx(300 * US)
    # launched under it: 1, 2, 5 and 3 -> 150-170, 200-400, 520-570
    assert sgd["device_s"] == pytest.approx(270 * US)
    assert spans["repro_torch.plan"] == {"count": 1,
                                         "host_s": pytest.approx(50 * US),
                                         "device_s": 0.0}


def test_the_collectives(reduced):
    # nccl: 250-400, 810-850; others: 150-170, 200-300, 520-570
    assert reduced["collective_s"] == pytest.approx(190 * US)
    assert reduced["collective_exposed_s"] == pytest.approx(140 * US)


def test_merge_takes_the_slowest_ranks_seconds(reduced):
    assert trace.merge([reduced]) is reduced
    other = json.loads(json.dumps(reduced))
    other["window_s"] = 2.0
    other["busy_s"] = 1.0
    other["collective_s"] = 0.5
    other["span_device_s"]["chipbench.local_sgd"] = 0.25
    other["program_spans"]["repro_torch.local_sgd"]["device_s"] = 0.125
    other["program_spans"]["repro_torch.mix_update"] = {
        "count": 3, "host_s": 0.01, "device_s": 0.02}
    m = trace.merge([reduced, other])
    assert m["window_s"] == reduced["window_s"]
    assert m["busy_s"] == 1.0 and m["collective_s"] == 0.5
    assert m["collective_exposed_s"] == reduced["collective_exposed_s"]
    assert m["span_device_s"]["chipbench.local_sgd"] == 0.25
    assert m["program_spans"]["repro_torch.local_sgd"] == {
        "count": 2, "host_s": pytest.approx(300 * US), "device_s": 0.125}
    assert m["program_spans"]["repro_torch.mix_update"]["device_s"] == 0.02
    assert m["device_ops"] == reduced["device_ops"]
