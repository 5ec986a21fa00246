"""The span recorder (zutis_tpu_torch/core/profiling.py) and the spans the
port places: off, a span site records, allocates and enters nothing; on
(under `profiling.trace` or `record_spans(True)`) spans nest by thread,
keep their ids across threads, fall into numbered sessions, count what the
cap drops, and sit on the Chrome trace's clock beside their own
annotations. The server's queue and batch spans and the training step's
split on the CPU, and the benchmark's span readers (benchmark/metrics/) on
synthetic sessions and on none. The file imports no JAX."""
import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from zutis_tpu_torch.core import profiling
from zutis_tpu_torch.engine.server import InferenceServer
from zutis_tpu_torch.engine.train_step import TrainState, make_train_step
from zutis_tpu_torch.models.zutis import ZUTIS

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(width=32, encoder_layers=1, encoder_heads=2, patch_size=16,
           text_dim=16, n_queries=8, n_decoder_layers=2, n_heads=2,
           input_resolution=32)
TRAIN_CHILDREN = ("train.upload", "train.forward", "train.criterion",
                  "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def recorder():
    profiling.record_spans(False)
    profiling.clear()
    yield
    profiling.record_spans(False)
    profiling.clear()


def _by_name(session):
    out = {}
    for s in session["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def _inside(child, parent):
    return (parent["t0_ns"] <= child["t0_ns"]
            and child["t1_ns"] <= parent["t1_ns"])


# ---------------- the recorder ----------------

def test_off_a_span_site_records_allocates_and_enters_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("constructed while spans are off")
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("a", device=True, rid=1)
    with first as inside:
        assert inside is None
        with profiling.span("b", device=True):
            pass
    assert profiling.span("c") is first  # one shared no-op
    assert profiling.open_span("q", device=True, rid=2) is None
    profiling.close_span(None, bid=3)
    assert profiling.sessions() == []


@pytest.mark.parametrize("how", ["trace", "record_spans"])
def test_spans_nest_by_thread_and_keep_their_ids_across_threads(how,
                                                                 tmp_path):
    on = (profiling.trace(str(tmp_path)) if how == "trace"
          else _recording())
    with on:
        with profiling.span("outer", bid=7) as outer:
            with profiling.span("inner"):
                queued = profiling.open_span("queue", rid=3)
            with profiling.span("sibling"):
                pass
        t = threading.Thread(target=profiling.close_span,
                             args=(queued,), kwargs=dict(bid=7))
        t.start()
        t.join()
        with profiling.span("later", parent=outer):
            pass
    (session,) = profiling.sessions()
    names = _by_name(session)
    outer_id = names["outer"][0]["id"]
    assert names["outer"][0]["parent"] is None
    assert names["outer"][0]["ids"] == {"bid": 7}
    assert names["inner"][0]["parent"] == outer_id
    assert names["sibling"][0]["parent"] == outer_id
    assert names["queue"][0]["parent"] == names["inner"][0]["id"]
    assert names["queue"][0]["ids"] == {"rid": 3, "bid": 7}
    assert names["later"][0]["parent"] == outer_id
    for s in session["spans"]:
        assert s["t1_ns"] >= s["t0_ns"] and s["device_ms"] is None


class _recording:
    def __enter__(self):
        profiling.record_spans(True)

    def __exit__(self, *exc):
        profiling.record_spans(False)


def test_sessions_are_numbered_across_an_off_stretch(tmp_path):
    with profiling.trace(str(tmp_path / "one")):
        with profiling.span("a"):
            pass
        with profiling.span("b"):
            pass
    with profiling.span("off"):
        pass
    profiling.record_spans(True)
    with profiling.span("c"):
        pass
    profiling.record_spans(False)
    with profiling.trace(str(tmp_path / "two")):
        with profiling.span("d"):
            pass
    got = profiling.sessions()
    assert [[s["name"] for s in ses["spans"]] for ses in got] == [
        ["a", "b"], ["c"], ["d"]]
    numbers = [ses["number"] for ses in got]
    assert numbers == list(range(numbers[0], numbers[0] + 3))
    # a span still open when its session ends is read as open
    profiling.record_spans(True)
    left_open = profiling.open_span("open")
    profiling.record_spans(False)
    assert profiling.sessions()[-1]["spans"][0]["t1_ns"] is None
    profiling.close_span(left_open)
    assert profiling.sessions()[-1]["spans"][0]["t1_ns"] is not None


def test_the_cap_counts_the_spans_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with _recording():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
        assert profiling.open_span("q") is None
    (session,) = profiling.sessions()
    assert [s["name"] for s in session["spans"]] == ["s0", "s1", "s2"]
    assert session["dropped"] == 3


def test_the_anchor_puts_a_span_on_the_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("mark"):
            x = torch.ones(256, 256)
            for _ in range(20):
                x = (x @ x) / 256.0
            time.sleep(0.01)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    (event,) = [e for e in trace["traceEvents"]
                if e.get("name") == "mark" and e.get("cat") == "user_annotation"]
    (session,) = profiling.sessions()
    (mark,) = session["spans"]
    ts, dur = profiling.trace_interval(mark, session,
                                       trace["baseTimeNanoseconds"])
    assert abs(ts - float(event["ts"])) < 1000.0  # µs
    assert abs((ts + dur) - (float(event["ts"]) + float(event["dur"]))) < 1000.0
    assert dur >= 10_000.0


def test_span_ms_reads_host_and_device_intervals():
    session = {"spans": [
        _span("a", 0, 2_000_000, device_ms=1.5),
        _span("a", 5_000_000, 6_000_000, device_ms=0.5),
        _span("a", 7_000_000, None),  # still open
        _span("a", 8_000_000, 9_000_000, cancelled=True),
        _span("a", 9_000_000, 19_000_000, outlived=True),
        _span("b", 0, 1_000_000)]}
    assert profiling.span_ms(session, "a") == [2.0, 1.0]
    assert profiling.span_ms(session, "a", device=True) == [1.5, 0.5]
    assert profiling.span_ms(session, "b", device=True) is None
    assert profiling.span_ms(session, "c") == []


@pytest.mark.parametrize("ended_by", ["record_spans", "a later session"])
def test_a_span_that_outlives_its_session_is_marked_and_not_counted(
        ended_by, tmp_path):
    profiling.record_spans(True)
    kept = profiling.open_span("server.queue", rid=0)
    late = profiling.open_span("server.queue", rid=1)
    with profiling.span("server.batch", bid=0):
        profiling.close_span(kept, bid=0)
        time.sleep(0.002)
    if ended_by == "record_spans":
        profiling.record_spans(False)
    else:  # recording seen off by a site, then a new session begun
        profiling.record_spans(False)
        with profiling.span("off"):
            pass
        with profiling.trace(str(tmp_path)):
            with profiling.span("server.batch", bid=1):
                pass
    time.sleep(0.002)
    profiling.close_span(late, bid=1)
    first = profiling.sessions()[0]
    queue = sorted(_by_name(first)["server.queue"],
                   key=lambda s: s["ids"]["rid"])
    assert queue[0]["ids"] == {"rid": 0, "bid": 0}
    assert queue[1]["ids"] == {"rid": 1, "bid": 1, "outlived": True}
    assert queue[1]["t1_ns"] is not None
    (waited,) = profiling.span_ms(first, "server.queue")
    assert waited == pytest.approx((queue[0]["t1_ns"] - queue[0]["t0_ns"])
                                   * 1e-6)
    assert "outlived" not in _by_name(first)["server.batch"][0]["ids"]
    assert profiling.first_session("server.batch")["number"] == first[
        "number"]


# ---------------- the port's spans ----------------

@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    model = ZUTIS(**CFG, device="cpu").init_params()
    rng = np.random.RandomState(0)
    text = rng.randn(5, 16).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    images = [rng.randn(3, 32, 32).astype(np.float32) for _ in range(7)]
    return model, text, images


def test_server_spans_a_request_queue_and_each_batch(tiny):
    model, text, images = tiny
    srv = InferenceServer(model, text, image_size=32, batch_size=4,
                          threshold=0.4, max_wait_ms=20, device="cpu")
    gate, calls, infer = threading.Event(), [], srv.infer

    def held_infer(imgs):
        calls.append(len(imgs))
        assert gate.wait(timeout=120)
        return infer(imgs)

    srv.infer = held_infer
    profiling.record_spans(True)
    srv.start()
    try:
        first = srv.submit(images[0])
        t0 = time.monotonic()
        while not calls:
            assert time.monotonic() - t0 < 60
            time.sleep(0.01)
        queued = [srv.submit(images[i]) for i in range(1, 5)]
        assert queued[1].cancel()
        gate.set()
        for f in [first] + queued[:1] + queued[2:]:
            f.result(timeout=120)
    finally:
        gate.set()
        srv.stop()
        profiling.record_spans(False)
    (session,) = profiling.sessions()
    names = _by_name(session)
    batches = {s["ids"]["bid"]: s for s in names["server.batch"]}
    assert len(batches) == 2 == srv.batches
    queue = sorted(names["server.queue"], key=lambda s: s["ids"]["rid"])
    assert [s["ids"]["rid"] for s in queue] == [0, 1, 2, 3, 4]
    assert queue[2]["ids"] == {"rid": 2, "cancelled": True}
    served = [s["ids"]["bid"] for i, s in enumerate(queue) if i != 2]
    assert served == [0, 1, 1, 1]
    for s in queue:
        assert s["t1_ns"] is not None
        if "bid" in s["ids"]:  # taken before its batch began
            assert s["t1_ns"] <= batches[s["ids"]["bid"]]["t0_ns"]
    for kind in ("server.upload", "server.finish"):
        assert len(names[kind]) == 2
        for s in names[kind]:
            parent = next(b for b in batches.values() if b["id"] == s["parent"])
            assert _inside(s, parent)
    assert profiling.span_ms(session, "server.queue") == pytest.approx(
        [(s["t1_ns"] - s["t0_ns"]) * 1e-6 for i, s in enumerate(queue)
         if i != 2])


def test_synchronous_infer_spans_each_chunk(tiny):
    model, text, images = tiny
    srv = InferenceServer(model, text, image_size=32, batch_size=4,
                          threshold=0.4, device="cpu")
    with _recording():
        srv.infer(images)  # 7 images: two chunks
    (session,) = profiling.sessions()
    names = _by_name(session)
    assert [s["ids"]["bid"] for s in names["server.batch"]] == [0, 1]
    assert "server.queue" not in names
    assert len(names["server.upload"]) == len(names["server.finish"]) == 2


def _train_batch(rng, b=2, size=32, n_max=3, n_cat=5):
    masks = np.zeros((b, n_max, size, size), np.float32)
    masks[:, 0, :16], masks[:, 1, 16:] = 1.0, 1.0
    valid = np.zeros((b, n_max), bool)
    valid[:, :2] = True
    return {"image": rng.randn(b, 3, size, size).astype(np.float32),
            "instance_masks": masks, "instance_valid": valid,
            "semantic_mask": rng.randint(0, n_cat, (b, size, size)
                                         ).astype(np.int32)}


def test_train_step_spans_its_phases_inside_the_step(tmp_path):
    torch.manual_seed(1)
    model = ZUTIS(**CFG, device="cpu").init_params()
    text = np.random.RandomState(1).randn(5, 16).astype(np.float32)
    state = TrainState.create(model, base_lr=1e-3, n_iters=4)
    step = make_train_step(model, text, 5, device="cpu")
    rng = np.random.RandomState(2)
    step(state, _train_batch(rng))  # off: nothing recorded
    assert profiling.sessions() == []
    with profiling.trace(str(tmp_path)):
        for _ in range(2):
            step(state, _train_batch(rng))
    (session,) = profiling.sessions()
    names = _by_name(session)
    steps = names["train.step"]
    assert len(steps) == 2 and all(s["parent"] is None for s in steps)
    for name in TRAIN_CHILDREN + ("train.matcher",):
        want = 4 if name == "train.optimizer" else 2
        assert len(names[name]) == want, name
        for s in names[name]:
            assert s["device_ms"] is None
    for name in TRAIN_CHILDREN:
        for s in names[name]:
            (parent,) = [p for p in steps if p["id"] == s["parent"]]
            assert _inside(s, parent)
    for s in names["train.matcher"]:
        (parent,) = [p for p in names["train.criterion"]
                     if p["id"] == s["parent"]]
        assert _inside(s, parent)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        annotated = {e.get("name") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "user_annotation"}
    assert {"train.step", "train.matcher", *TRAIN_CHILDREN} <= annotated


# ---------------- the benchmark's readers ----------------

READERS = ["train.upload_ms", "train.forward_ms", "train.criterion_ms",
           "train.matcher_ms", "train.backward_ms", "train.optimizer_ms",
           "serve.queue_p95_ms", "serve.batch_ms", "serve.upload_ms",
           "serve.finish_ms", "serve_max.upload_ms", "serve_max.finish_ms"]


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(name, t0, t1, device_ms=None, **ids):
    return {"name": name, "id": 0, "parent": None, "ids": ids,
            "t0_ns": t0, "t1_ns": t1, "device_ms": device_ms}


MS = 1_000_000


def _synthetic(device=True):
    """A training session of 2 steps and a serving one of 4 batches,
    behind a session that holds neither parent span and before a later
    training one."""
    dev = (lambda ms: ms) if device else (lambda ms: None)
    train = [_span("train.step", 0, 100 * MS), _span("train.step", 0, 90 * MS)]
    for k, (name, ms) in enumerate([("train.upload", 3), ("train.forward", 20),
                                    ("train.criterion", 30),
                                    ("train.matcher", 4),
                                    ("train.backward", 40),
                                    ("train.optimizer", 2),
                                    ("train.optimizer", 5)]):
        for step in range(2):
            train.append(_span(name, 0, (ms + step) * MS, dev(ms + 2 * step)))
    serve = []
    for bid in range(4):
        # the last batch's finish runs on through the profile's stop
        late = dict(outlived=True) if bid == 3 else {}
        serve.append(_span("server.batch", 0,
                           (60 + 10 * bid + (400 if late else 0)) * MS,
                           bid=bid, **late))
        serve.append(_span("server.upload", 0, (4 + bid) * MS))
        serve.append(_span("server.finish", 0,
                           (30 + bid + (400 if late else 0)) * MS, **late))
    for rid in range(20):
        serve.append(_span("server.queue", 0, (rid + 1) * MS, rid=rid,
                           bid=rid // 5))
    for rid in range(22, 25):  # taken only after the stop
        serve.append(_span("server.queue", 0, 2000 * MS, rid=rid, bid=4,
                           outlived=True))
    serve.append(_span("server.queue", 0, 500 * MS, rid=20, cancelled=True))
    serve.append(_span("server.queue", 0, None, rid=21))
    session = lambda n, spans: {"number": n, "anchor": (0, 0), "dropped": 0,
                                "spans": spans}
    later = [_span("train.step", 0, MS)] + [
        _span(name, 0, 500 * MS, dev(500)) for name in TRAIN_CHILDREN
        + ("train.matcher",)]
    return [session(0, [_span("other", 0, MS)]), session(1, train),
            session(2, serve), session(3, later)]


WANT = {"train.upload_ms": 3.5, "train.forward_ms": 21.0,
        "train.criterion_ms": 31.0, "train.matcher_ms": 5.0,
        "train.backward_ms": 41.0, "train.optimizer_ms": 9.0,
        "serve.queue_p95_ms": float(np.percentile(np.arange(1, 21), 95)),
        "serve.batch_ms": 70.0, "serve.upload_ms": 5.5,
        "serve.finish_ms": 31.0, "serve_max.upload_ms": 5.5,
        "serve_max.finish_ms": 31.0}
DEVICE = {"train.forward_ms", "train.criterion_ms", "train.matcher_ms",
          "train.backward_ms", "train.optimizer_ms"}


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_synthetic_recorder(name, monkeypatch):
    monkeypatch.setattr(profiling, "sessions", lambda: _synthetic())
    assert _reader(name).read({}) == pytest.approx(WANT[name])
    monkeypatch.setattr(profiling, "sessions", lambda: _synthetic(False))
    got = _reader(name).read({})
    assert got is None if name in DEVICE else got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_on_an_empty_recorder(name, monkeypatch):
    assert _reader(name).read({}) is None
    monkeypatch.setattr(profiling, "sessions", lambda: _synthetic()[:1])
    assert _reader(name).read({}) is None
    # a program without the recorder (the benchmark runs on older ones)
    monkeypatch.delattr(profiling, "first_session")
    assert _reader(name).read({}) is None
