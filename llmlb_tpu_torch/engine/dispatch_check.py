"""Fail when a decode-loop step launches more than one model step.

Counterpart of `scripts/check_fused_dispatch.py`. On the card a decode
burst or verify step is one CUDA graph replay per (window, seeded, mode)
key, after one eager step per key that the capture follows; the step
records (`dispatches`, engine/stepstats.py) count what each step launched:
1 for a replay, the model step calls for an eager step. This check drives
one debug-size core with int8 KV pages, an adapter, speculative decoding
and a JSON-schema row all active in one batch, and fails

- if the mix did not engage (a vacuous pass is a finding): no verify
  record, no grammar-key step (a masked step with no fallback and the
  schema in the device table), no adapter row;
- on the card, if a decode or verify record counts more than one dispatch
  beyond each graph key's one eager warm-up, or if the records' dispatch
  tally disagrees with the metrics'.

Run: `python -m llmlb_tpu_torch.engine.dispatch_check` (on the card;
`--device cpu` runs the plain path, where every step is eager and one
model step).
"""

from __future__ import annotations

import argparse
import sys
import tempfile

from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
from llmlb_tpu_torch.lora import save_adapter
from llmlb_tpu_torch.structured import ConstraintCompiler

SCHEMA = {
    "type": "object",
    "properties": {
        "ok": {"type": "boolean"},
        "tag": {"enum": ["alpha", "beta"]},
    },
    "required": ["ok", "tag"],
}

# a repetitive prompt, so the prompt-lookup drafter proposes
PROMPT = [5, 6, 7, 8, 9] * 5


def _drain(request) -> list[int]:
    toks = []
    while True:
        kind, val = request.events.get(timeout=300)
        if kind == "token":
            toks.append(val)
        elif kind == "done":
            return toks
        else:
            raise RuntimeError(f"engine error: {val}")


def run_check(device: str = "cuda") -> list[str]:
    """Drive the four-feature batch; return the findings (none: pass)."""
    cfg = get_preset("debug-tiny")
    tok = ByteTokenizer(cfg.vocab_size)
    with tempfile.TemporaryDirectory() as lora_dir:
        save_adapter(lora_dir, "acme", cfg, rank=4)
        core = EngineCore(
            cfg, num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
            kv_layout="paged", kv_page_size=16, seed=0, device=device,
            quantize="kv", lora_dir=lora_dir, spec_decode=True,
            fused_decode=True, prefix_cache=False, eos_id=tok.eos_id)
        core.constraint_compiler = ConstraintCompiler(tok, cfg.vocab_size)
        core.start()
        try:
            return _check(core)
        finally:
            core.stop()


def _check(core: EngineCore) -> list[str]:
    """Run the batch on a started core; its findings."""
    json_spec = {"type": "json_schema", "schema": SCHEMA}
    reqs = [
        # plain greedy
        Request(prompt_ids=list(PROMPT), sampling=SamplingParams(
            temperature=0.0, max_tokens=16)),
        # adapter, seeded
        Request(prompt_ids=list(PROMPT), sampling=SamplingParams(
            temperature=0.8, seed=7, max_tokens=16, lora="acme")),
        # JSON-constrained greedy in the same batch
        Request(prompt_ids=list(PROMPT), sampling=SamplingParams(
            temperature=0.0, max_tokens=24, constraint=json_spec)),
        # JSON-constrained with the adapter, seeded
        Request(prompt_ids=list(PROMPT), sampling=SamplingParams(
            temperature=0.9, seed=42, max_tokens=24, lora="acme",
            constraint=json_spec)),
    ]
    for r in reqs:
        core.submit(r)
    for r in reqs:
        _drain(r)

    findings: list[str] = []
    records = core.step_stats.snapshot(limit=core.step_stats.capacity)[
        "records"]
    steps = [r for r in records if r["kind"] in ("decode", "verify")]
    stats = core.stats()
    # the mix must have engaged, else the pass is vacuous
    if not any(r["kind"] == "verify" for r in steps):
        findings.append("no verify record: speculation never engaged")
    st = stats.structured
    if st.masked_decode_steps_total == 0:
        findings.append("no grammar-masked decode step ran")
    if st.constrained_burst_fallback_total:
        findings.append(f"{st.constrained_burst_fallback_total} constrained "
                        "burst(s) fell back to the host mask")
    table = core.structured_info()["grammar_table"]
    if not table.get("schemas"):
        findings.append("no schema registered in the device grammar table")
    if core.metrics.lora_requests_total.get("acme", 0) == 0:
        findings.append("no adapter row: the acme requests never pinned it")
    if stats.spec.verify_steps_total == 0:
        findings.append("no speculative verify step counted")
    tally = sum(r["dispatches"] for r in steps)
    if tally != core.metrics.decode_dispatches_total:
        findings.append(f"dispatch ledger {core.metrics.decode_dispatches_total}"
                        f" != the records' {tally}")
    if core.decode_graphs:
        info = core.decode_graph_info()
        # each key runs one eager step, its warm-up; every later step of
        # the key replays
        warmups = info["eager_bursts"] + info["verify"]["eager_bursts"]
        keys = info["graphs"] + info["verify"]["graphs"]
        if warmups != keys:
            findings.append(f"{warmups} eager steps for {keys} graph keys")
        multi = [r for r in steps if r["dispatches"] > 1]
        if len(multi) > warmups:
            for r in multi:
                findings.append(f"step seq={r['seq']} kind={r['kind']} "
                                f"launched {r['dispatches']} model steps")
        if info["replays"] + info["verify"]["replays"] == 0:
            findings.append("no decode or verify step replayed a graph")
    return findings


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    findings = run_check(args.device)
    for what in findings:
        print(what, file=sys.stderr)
    if findings:
        print(f"\n{len(findings)} dispatch finding(s)", file=sys.stderr)
        return 1
    print("every decode and verify step launched one model step after its "
          "key's warm-up; speculation, the grammar key, int8 KV and an "
          "adapter all engaged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
