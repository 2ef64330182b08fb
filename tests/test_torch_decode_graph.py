"""The decode burst made ready for CUDA graphs (engine/decode_graph.py), on
the CPU at debug-tiny size. No JAX engine is built here: the streams are
held against the port's own decode_burst=1 run, which
tests/test_torch_engine.py, test_torch_dense.py and test_torch_lora.py hold
against the JAX engine.

- every device buffer a burst touches keeps its address across bursts,
  activations, page growth, a slot's free and a cache reset (a captured
  graph reads and writes fixed addresses);
- the paged and dense engines give the same greedy and seeded streams at
  decode_burst=8 as at decode_burst=1;
- the (window bucket, seeded) key `_decode_active` picks;
- launch accounting: a capture's kernel counts leave the totals and every
  replay adds them, here with a stub graph object;
- an engine whose bursts replay stub graphs (each replay runs the eager
  body) streams what the eager engine streams, and counts one eager burst
  per key and a replay for every other burst;
- decode_graphs is off on the CPU, and asking for it there raises.
"""

import numpy as np
import pytest

from llmlb_tpu_torch.engine.decode_graph import BurstGraphs
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.kernels import build

CFG = get_preset("debug-tiny")
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0, device="cpu")
PROMPT_LENS = (5, 12, 20, 9, 14)  # five prompts for four slots
GREEDY = dict(temperature=0.0)
SEEDED = dict(temperature=0.8, top_p=0.9, seed=11)


def _prompts(lens=PROMPT_LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(n,)).tolist() for n in lens]


def _step(core: EngineCore) -> bool:
    """One iteration of the engine's step loop, on the caller's thread."""
    did = core._try_insert()
    did |= core._advance_prefill()
    did |= core._decode_active()
    return did


def _drain(request: Request) -> tuple[list[int], str]:
    toks = []
    while True:
        kind, value = request.events.get_nowait()
        if kind == "token":
            toks.append(int(value))
        elif kind == "done":
            return toks, value
        else:
            raise AssertionError(f"engine error: {value}")


def _serve(core: EngineCore, prompts, samplings, check=None):
    """Submit everything, step the loop until idle (calling check(core)
    after every iteration), and return each request's (tokens, reason)."""
    reqs = [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
        **s))) for p, s in zip(prompts, samplings)]
    while _step(core):
        if check is not None:
            check(core)
    return [_drain(r) for r in reqs]


def _addresses(core: EngineCore) -> dict:
    bufs = {"last_tokens": core._d_last_tokens, "seq_lens": core._d_seq_lens,
            "tokens": core._d_tokens}
    if core._d_block_tables is not None:
        bufs["block_tables"] = core._d_block_tables
    return {name: t.data_ptr() for name, t in bufs.items()}


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_burst_buffers_keep_their_addresses(layout):
    core = EngineCore(CFG, decode_burst=8, kv_layout=layout, **CORE_KW)
    want = _addresses(core)
    seen = {"decodes": 0, "grown": 0, "freed": 0}
    pages = {}

    def check(c):
        assert _addresses(c) == want
        seen["decodes"] = c.decode_bursts
        for i, row in enumerate(c._slot_pages):
            seen["grown"] += len(row) > pages.get(i, len(row))
            seen["freed"] += bool(pages.get(i)) and not row
            pages[i] = len(row)

    # max_tokens 30 crosses a 16-token page; the five requests share four
    # slots, so a slot frees and is activated again
    out = _serve(core, _prompts(), [dict(GREEDY, max_tokens=30)] * 5, check)
    assert [r for _t, r in out] == ["length"] * 5
    assert seen["decodes"] >= 4
    if layout == "paged":
        assert seen["grown"] and seen["freed"]
        # the device table holds the host's
        assert np.array_equal(core._d_block_tables.numpy(),
                              core._block_tables)
    core._reset_caches()
    assert _addresses(core) == want


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_burst_8_streams_equal_burst_1(layout):
    prompts = _prompts()
    samplings = [dict(GREEDY, max_tokens=13), dict(SEEDED, max_tokens=11),
                 dict(GREEDY, max_tokens=20),
                 dict(temperature=1.0, top_k=20, seed=5, max_tokens=9),
                 dict(GREEDY, max_tokens=10)]
    streams = {}
    for burst in (1, 8):
        core = EngineCore(CFG, decode_burst=burst, kv_layout=layout,
                          **CORE_KW)
        streams[burst] = _serve(core, prompts, samplings)
        assert core.nan_logit_rows() == 0
    assert streams[8] == streams[1]
    assert [len(t) for t, _r in streams[8]] == [13, 11, 20, 9, 10]


def test_decode_key_is_window_bucket_and_seeded():
    """Windows are powers of two from 256 up to the capacity and cover
    every active row plus the burst; `seeded` is any active row's seed."""
    core = EngineCore(CFG, decode_burst=8, **{**CORE_KW,
                                             "slot_capacity": 512,
                                             "prefill_buckets": (32, 256)})
    assert core._window_buckets == (256, 512)
    keys = []
    run = core._bursts.run
    core._bursts.run = lambda w, s: (keys.append((w, s)), run(w, s))
    _serve(core, _prompts((20,)), [dict(GREEDY, max_tokens=9)])
    assert set(keys) == {(256, False)}
    keys.clear()
    _serve(core, _prompts((20,)), [dict(SEEDED, max_tokens=9)])
    assert set(keys) == {(256, True)}
    keys.clear()
    # 250 + 8 + 1 > 256 from the first burst on
    _serve(core, _prompts((250, 10)), [dict(GREEDY, max_tokens=9),
                                       dict(SEEDED, max_tokens=9)])
    assert set(keys) == {(512, True)}
    keys.clear()
    _serve(core, _prompts((250,)), [dict(GREEDY, max_tokens=9)])
    assert set(keys) == {(512, False)}


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: replay() runs `on_replay`."""

    def __init__(self, on_replay=None):
        self.replays = 0
        self._on_replay = on_replay

    def replay(self):
        self.replays += 1
        if self._on_replay is not None:
            self._on_replay()


def test_launch_accounting_around_capture_and_replay():
    build.reset_launch_counts()
    per_burst = {"paged_flash_decode": 256, "lora_delta": 1792}
    bodies = []

    def body(window, seeded):
        # what the wrappers count while the body runs, eagerly or captured
        bodies.append((window, seeded))
        build.add_launches(per_burst)

    graphs = []

    def capture(fn):
        fn()  # the Python runs under capture; the kernels are recorded
        graphs.append(_StubGraph())
        return graphs[-1], 0, None

    bursts = BurstGraphs(body, capture)
    bursts.run(256, False)  # eager warm-up, then capture
    assert bodies == [(256, False)] * 2
    assert build.launches_since({}) == per_burst  # the capture's taken out
    for _ in range(3):
        bursts.run(256, False)
    assert graphs[0].replays == 3 and len(bodies) == 2
    assert build.LAUNCHES["paged_flash_decode"] == 4 * 256
    assert build.LAUNCHES["lora_delta"] == 4 * 1792
    bursts.run(512, True)
    bursts.run(512, True)
    info = bursts.info()
    assert (info["graphs"], info["replays"], info["eager_bursts"]) == (2, 4, 2)
    assert info["keys"]["512/seeded"]["launches"] == per_burst
    assert build.LAUNCHES["paged_flash_decode"] == 6 * 256
    build.reset_launch_counts()


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_replayed_bursts_stream_what_eager_bursts_stream(layout):
    """Swap the engine's burst runner for one whose 'graphs' replay the
    eager body: the scheduler drives it as it drives CUDA graphs, and the
    streams and counters come out as on the card."""
    prompts = _prompts()
    samplings = [dict(GREEDY, max_tokens=20), dict(SEEDED, max_tokens=17),
                 dict(GREEDY, max_tokens=24), dict(SEEDED, max_tokens=9),
                 dict(GREEDY, max_tokens=12)]
    eager = EngineCore(CFG, decode_burst=4, kv_layout=layout, **CORE_KW)
    want = _serve(eager, prompts, samplings)
    stats = eager.stats()
    assert stats.decode_eager_bursts == eager.decode_bursts
    assert (stats.decode_graph_replays, stats.decode_graphs) == (0, 0)

    core = EngineCore(CFG, decode_burst=4, kv_layout=layout, **CORE_KW)
    core._bursts = BurstGraphs(core._burst_body, lambda fn: (
        _StubGraph(fn), 0, None))
    assert _serve(core, prompts, samplings) == want
    stats = core.stats()
    assert stats.decode_graphs == 2  # (128, False) and (128, True)
    assert stats.decode_eager_bursts == stats.decode_graphs
    assert (stats.decode_graph_replays + stats.decode_eager_bursts
            == core.decode_bursts)
    assert core.decode_graph_info()["keys"].keys() == {"128/unseeded",
                                                       "128/seeded"}


def test_decode_graphs_off_on_the_cpu():
    core = EngineCore(CFG, **CORE_KW)
    assert core.decode_graphs is False
    assert core.decode_graph_info()["enabled"] is False
    with pytest.raises(ValueError, match="decode_graphs needs the CUDA card"):
        EngineCore(CFG, decode_graphs=True, **CORE_KW)
