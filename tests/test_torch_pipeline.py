"""The port's edge pipeline and VDC offload against the JAX package's:
the same farms, queries and store/eviction scenarios give equal results,
and ``HybridExecutor`` agrees with the JAX executor on the CPU."""
import types

import numpy as np
import pytest
import torch

import repro.pipeline as jax_pipe
import repro.pipeline.adapters as jax_adapters
import repro.pipeline.service as jax_service
import repro.pipeline.streams as jax_streams
import repro_torch.pipeline as torch_pipe
import repro_torch.pipeline.adapters as torch_adapters
import repro_torch.pipeline.service as torch_service
import repro_torch.pipeline.streams as torch_streams
from repro_torch import resolve_device

torch.set_num_threads(2)


def _ns(pipe, service, streams, adapters):
    return types.SimpleNamespace(
        Broker=pipe.Broker, NeubotFarm=pipe.NeubotFarm, Pipeline=pipe.Pipeline,
        TimeSeriesStore=pipe.TimeSeriesStore, WindowSpec=pipe.WindowSpec,
        neubot_query_1=pipe.neubot_query_1, neubot_query_2=pipe.neubot_query_2,
        StreamService=service.StreamService, ServiceConfig=service.ServiceConfig,
        Record=streams.Record, StageAdapter=adapters.StageAdapter)


JAX = _ns(jax_pipe, jax_service, jax_streams, jax_adapters)
PORT = _ns(torch_pipe, torch_service, torch_streams, torch_adapters)


def _neubot_hour(P):
    """8 things at 1 Hz for one hour, Q1 and Q2 fetching every minute."""
    broker = P.Broker()
    stores = [P.TimeSeriesStore("speedtests", chunk_seconds=600.0,
                                edge_budget_chunks=3) for _ in range(2)]
    farm = P.NeubotFarm(broker, n_things=8, rate_hz=1.0, seed=0)
    q1 = P.neubot_query_1(broker, stores[0])
    q2 = P.neubot_query_2(broker, stores[1])
    pipe = P.Pipeline(broker).add_farm(farm).add_service(q1).add_service(q2)
    for minute in range(1, 61):
        pipe.advance_to(60.0 * minute)
    return (q1.results, q2.results, q1.buffer_evictions, q2.buffer_evictions,
            [(s.spill_events, s.resident_chunks) for s in stores])


def test_neubot_hour_equals_jax():
    port, ref = _neubot_hour(PORT), _neubot_hour(JAX)
    assert len(port[0]) == 60 and len(port[1]) == 12
    assert [(r["ts"], r["n"], r["value"]) for r in port[0]] == \
        [(r["ts"], r["n"], r["value"]) for r in ref[0]]
    assert port == ref


# --- the store-scan and eviction-accounting cases of tests/test_pipeline.py --
def _queue_offsets(P):
    q = P.Broker().queue("q", capacity=10)
    q.register("c1")
    for i in range(15):
        q.publish(P.Record(ts=float(i), values={"v": float(i)}))
    got = q.fetch("c1")
    return q.dropped, [r.values["v"] for r in got], q.fetch("c1")


def _store_scan(P):
    s = P.TimeSeriesStore("t", chunk_seconds=10.0, edge_budget_chunks=2)
    for i in range(100):
        s.append(P.Record(ts=float(i), values={"v": float(i)}))
    s.flush()
    return (s.scan(25.0, 75.0, "v").tolist(), s.spill_events,
            s.resident_chunks, s.count(0.0, 50.0),
            s.scan(0.0, 100.0, "v", include_spilled=False).tolist())


def _service(P, name, agg, width, budget, store):
    broker = P.Broker()
    svc = P.StreamService(P.ServiceConfig(
        name=name, queue="q", column="v", agg=agg,
        window=P.WindowSpec("sliding", width, 10.0), buffer_budget=budget,
        store=store), broker)
    return svc, broker.queue("q")


def _eviction_spills_to_store(P):
    store = P.TimeSeriesStore("s", chunk_seconds=100)
    svc, q = _service(P, "tiny", "mean", 50.0, 16, store)
    for i in range(200):
        q.publish(P.Record(ts=float(i), values={"v": 1.0}))
    res = svc.run_until(200.0)
    return svc.buffer_evictions, len(svc.buffer), res


def _fetch_spill_accounting(P):
    store = P.TimeSeriesStore("s", chunk_seconds=1000.0)
    svc, q = _service(P, "tiny", "sum", 50.0, 16, store)
    for i in range(100):
        q.publish(P.Record(ts=float(i), values={"v": float(i)}))
    n = svc.fetch()
    store.flush()
    return (n, svc.buffer_evictions, [r.ts for r in svc.buffer],
            sorted(store.scan(0.0, 84.0, "v").tolist()), svc.fire(100.0))


def _eviction_without_store(P):
    svc, q = _service(P, "lossy", "count", 50.0, 16, None)
    for i in range(100):
        q.publish(P.Record(ts=float(i), values={"v": 1.0}))
    svc.fetch()
    return svc.buffer_evictions, len(svc.buffer), svc.fire(100.0)


def _evictions_accumulate(P):
    svc, q = _service(P, "inc", "mean", 1000.0, 8, None)
    seen = []
    for lo, hi in ((0, 8), (8, 12), (12, 14)):
        for i in range(lo, hi):
            q.publish(P.Record(ts=float(i), values={"v": 1.0}))
        svc.fetch()
        seen.append((svc.buffer_evictions, [r.ts for r in svc.buffer]))
    return seen


def _mashup(P):
    """Q1's sink republishes into a queue that a second service reads."""
    broker = P.Broker()
    farm = P.NeubotFarm(broker, n_things=3, rate_hz=1.0, seed=1)
    q1 = P.neubot_query_1(broker, P.TimeSeriesStore("s", chunk_seconds=600))
    down = P.StreamService(P.ServiceConfig(
        name="max_of_max", queue="q1_out", column="value", agg="max",
        window=P.WindowSpec("sliding", 300.0, 300.0)), broker)
    pipe = P.Pipeline(broker).add_farm(farm).add_service(q1).add_service(down)
    pipe.connect(q1, "q1_out")
    out = [pipe.advance_to(60.0 * minute) for minute in range(1, 16)]
    assert [r["n"] for r in down.results] == [4, 5, 5]
    return out, pipe.topology()


def _stage_adapter(P):
    svc, q = _service(P, "stage", "max", 30.0, 64, None)
    for i in range(50):
        q.publish(P.Record(ts=float(i), values={"v": float(i % 7)}))
    st = P.StageAdapter(svc, None, None)
    backlog = st.backlog()
    return (list(st.fire_times(60.0)), backlog, st.fetch(), st.backlog(),
            st.peek_window(40.0), st.fire(40.0))


SCENARIOS = [_queue_offsets, _store_scan, _eviction_spills_to_store,
             _fetch_spill_accounting, _eviction_without_store,
             _evictions_accumulate, _mashup, _stage_adapter]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__.lstrip("_") for f in SCENARIOS])
def test_scenario_equals_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def test_fetch_spill_accounting_pins():
    """The port's own numbers for the exact-accounting case (as pinned for
    the JAX package in tests/test_pipeline.py)."""
    n, evicted, kept, spilled, res = _fetch_spill_accounting(PORT)
    assert n == 100 and evicted == 49 + 35
    assert kept == [float(i) for i in range(84, 100)]
    assert spilled == [float(i) for i in range(84)]
    assert res["n"] == 50


# --- the VDC offload ---------------------------------------------------------
def _speeds(n, seed=0):
    """Download speeds in bit/s, shaped like the producers' records."""
    rng = np.random.default_rng(seed)
    return np.maximum(rng.standard_normal(n, dtype=np.float32) * 4e6 + 20e6,
                      np.float32(0.1e6))


@pytest.mark.parametrize("n", [500, 4096, 1_000_000])
@pytest.mark.parametrize("agg", ["max", "min", "sum", "mean"])
def test_executor_matches_jax(n, agg):
    vals = _speeds(n, seed=n)
    jx = jax_pipe.HybridExecutor(edge_budget=1000)
    hx = torch_pipe.HybridExecutor(edge_budget=1000, device="cpu")
    ref, got = jx.run_window(vals, agg), hx.run_window(vals, agg)
    if agg in ("max", "min") or n <= 1000:
        assert got == ref
    else:
        assert got == pytest.approx(ref, rel=1e-5)
        exact = {"sum": vals.sum(dtype=np.float64),
                 "mean": vals.mean(dtype=np.float64)}[agg]
        assert got == pytest.approx(exact, rel=1e-5)
    assert (hx.offloads, hx.edge_runs) == (jx.offloads, jx.edge_runs)
    assert hx.offloads == (n > 1000)


def test_executor_takes_tensors():
    """A float32 tensor already on the executor's device is folded where
    it lies; other inputs are cast and copied once."""
    vals = _speeds(128 * 40, seed=3)
    hx = torch_pipe.HybridExecutor(edge_budget=1000, device="cpu")
    ref = hx.run_window(vals, "mean")
    assert hx.run_window(torch.from_numpy(vals), "mean") == ref
    assert hx.run_window(vals.astype(np.float64), "mean") == ref
    assert hx.run_window(torch.from_numpy(vals[:-3]), "max") == vals[:-3].max()
    assert hx.offloads == 4
    assert hx.run_window(torch.from_numpy(vals[:500]), "min") == vals[:500].min()
    assert hx.edge_runs == 1


def test_executor_default_device_is_the_card():
    if torch.cuda.is_available():
        assert torch_pipe.HybridExecutor().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            torch_pipe.HybridExecutor()


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
