"""The port's structured-output pipeline against the JAX package's, exactly.

`llmlb_tpu_torch/structured/` is the port's own copy of
`llmlb_tpu/structured/` and `llmlb_tpu_torch/ops/grammar.py` the torch
counterpart of `llmlb_tpu/ops/grammar.py`. On the same specs and the same
byte vocabulary they must give the same character DFAs (states, segments,
transitions, accepting set), the same `allowed` and next-state tables, the
same bias rows and cursor walks, the same `inspect_request` verdicts and
messages over the reference's own cases (tests/structured/
test_constraints.py), and the same device table (rows, offsets, bytes,
refusals) with the same `grammar_bias` and `grammar_advance` gathers. The
tables are integers and the biases two constants, so every comparison is
exact. Nothing here builds an engine.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.ops import grammar as jgrammar
from llmlb_tpu.structured import constraint as jconstraint
from llmlb_tpu.structured import openai_api as japi
from llmlb_tpu.structured import regex_dfa as jdfa
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
from llmlb_tpu_torch.ops import grammar
from llmlb_tpu_torch.structured import constraint, openai_api, regex_dfa

V = 512
# the preemption test's bounded schema, the gateway test's, a weather tool
PREEMPT = {"type": "object",
           "properties": {"name": {"type": "string", "maxLength": 8},
                          "n": {"enum": [0, 1, 2, 3]}},
           "required": ["name", "n"]}
GATEWAY = {"type": "object",
           "properties": {"city": {"enum": ["sf", "nyc"]},
                          "celsius": {"type": "boolean"}},
           "required": ["city", "celsius"]}
WEATHER = {"type": "object",
           "properties": {"location": {"type": "string", "maxLength": 16},
                          "unit": {"enum": ["c", "f"]},
                          "days": {"type": "integer"}},
           "required": ["location", "unit"]}
SPECS = {
    "regex-int": {"type": "regex", "pattern": r"-?[0-9]+"},
    "regex-word": {"type": "regex", "pattern": r"(yes|no)\.?"},
    "regex-class": {"type": "regex", "pattern": r"[A-Z][a-z]{1,4}( [a-z]+)*"},
    "json_schema-preempt": {"type": "json_schema", "schema": PREEMPT},
    "json_schema-gateway": {"type": "json_schema", "schema": GATEWAY},
    "tool_call-weather": {"type": "tool_call", "name": "get_weather",
                          "schema": WEATHER},
    "json_object": {"type": "json_object"},
}


@pytest.fixture(scope="module")
def compilers():
    return (jconstraint.ConstraintCompiler(JaxByteTokenizer(V), V),
            constraint.ConstraintCompiler(ByteTokenizer(V), V))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_char_dfa_is_the_references(name):
    spec = SPECS[name]
    assert constraint.spec_regex(spec) == jconstraint.spec_regex(spec)
    assert constraint.spec_hash(spec) == jconstraint.spec_hash(spec)
    ref = jdfa.compile_regex(jconstraint.spec_regex(spec))
    got = regex_dfa.compile_regex(constraint.spec_regex(spec))
    assert got.num_states == ref.num_states
    assert got.start == ref.start
    assert got.accepting == ref.accepting
    assert got.boundaries == ref.boundaries
    assert got.trans == ref.trans


@pytest.mark.parametrize("name", sorted(SPECS))
def test_token_tables_are_the_references(compilers, name):
    """`allowed`, the next-state table and every state's bias row."""
    ref = compilers[0].compile_spec(SPECS[name])
    got = compilers[1].compile_spec(SPECS[name])
    assert got.allowed.dtype == ref.allowed.dtype
    np.testing.assert_array_equal(got.allowed, ref.allowed)
    table = got.transition_table()
    assert table.dtype == np.int32
    np.testing.assert_array_equal(table, ref.transition_table())
    for state in range(got.num_states):
        np.testing.assert_array_equal(got.bias_row(state),
                                      ref.bias_row(state))
    assert constraint.MASK_NEG == jconstraint.MASK_NEG
    assert constraint.MASK_NEG.dtype == np.float32


@pytest.mark.parametrize("name", ["json_schema-preempt", "tool_call-weather",
                                  "json_object"])
def test_cursor_walks_are_the_references(compilers, name):
    """Seeded random walks over the allowed tokens (EOS included, and now
    and then a refused one): both cursors agree step for step."""
    ref_tc = compilers[0].compile_spec(SPECS[name])
    got_tc = compilers[1].compile_spec(SPECS[name])
    rng = np.random.default_rng(7)
    for _ in range(20):
        ref = jconstraint.ConstraintState(ref_tc)
        got = constraint.ConstraintState(got_tc)
        for _step in range(60):
            ids = np.nonzero(got_tc.allowed[got.state])[0]
            token = (int(rng.integers(0, V)) if rng.random() < 0.05
                     else int(rng.choice(ids)))
            assert got.advance(token) == ref.advance(token)
            assert (got.state, got.violated, got.is_accepting) == (
                ref.state, ref.violated, ref.is_accepting)
            if token == got_tc.eos_id and got.is_accepting:
                break


def test_compiler_cache_and_info_are_the_references():
    specs = [{"type": "regex", "pattern": p} for p in "abcab"]
    ref = jconstraint.ConstraintCompiler(JaxByteTokenizer(V), V,
                                         max_entries=2)
    got = constraint.ConstraintCompiler(ByteTokenizer(V), V, max_entries=2)
    for spec in specs:
        ref.compile_spec(spec)
        got.compile_spec(spec)
    assert got._texts() == ref._texts()
    assert got.info() == ref.info()
    assert (got.compile_cache_hits, got.compile_cache_misses,
            got.evictions) == (ref.compile_cache_hits,
                               ref.compile_cache_misses, ref.evictions)


# the bodies of tests/structured/test_constraints.py's inspect cases, and
# the port server's malformed tool shapes
TOOLS = [{"type": "function",
          "function": {"name": "f", "parameters": {
              "type": "object", "properties": {}, "required": []}}}]
BODIES = [
    {"messages": []},
    {"response_format": {"type": "text"}},
    {"response_format": {"type": "json_object"}},
    {"response_format": {"type": "json_schema", "json_schema": {
        "name": "t", "schema": {"type": "object", "properties": {},
                                "required": []}}}},
    {"tools": TOOLS,
     "tool_choice": {"type": "function", "function": {"name": "f"}}},
    {"tools": TOOLS, "tool_choice": "required"},
    {"tools": TOOLS, "tool_choice": "auto"},
    {"tools": TOOLS * 2, "tool_choice": "required"},
    {"tools": [{"type": "function", "function": {"name": "g"}}],
     "tool_choice": "required"},
    {"response_format": {"type": "bogus"}},
    {"response_format": {"type": "json_schema"}},
    {"response_format": "json"},
    {"tool_choice": {"type": "function", "function": {"name": "missing"}}},
    {"response_format": {"type": "json_schema", "json_schema": {
        "name": "x", "schema": {"type": "object", "patternProperties": {}}}}},
    {"response_format": {"type": "json_object"},
     "tools": [{"type": "function", "function": {"name": "f"}}],
     "tool_choice": {"type": "function", "function": {"name": "f"}}},
    {"tool_choice": "required"},
    {"tool_choice": "required", "tools": [{"type": "function"}]},
    {"tool_choice": {"type": "grammar"}, "tools": TOOLS},
    {"tool_choice": "always", "tools": TOOLS},
]


def _verdict(api, body):
    try:
        r = api.inspect_request(body)
    except ValueError as e:
        return ("error", type(e).__name__, str(e))
    return None if r is None else (r.kind, r.spec, r.tool_name)


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_inspect_request_is_the_references(i):
    assert _verdict(openai_api, BODIES[i]) == _verdict(japi, BODIES[i])


def test_parse_seed_is_the_references():
    for body in ({}, {"seed": 42}, {"seed": -1}, {"seed": 2**40 + 3}):
        assert openai_api.parse_seed(body) == japi.parse_seed(body)
    for body in ({"seed": "42"}, {"seed": True}):
        with pytest.raises(ValueError) as got:
            openai_api.parse_seed(body)
        with pytest.raises(ValueError) as ref:
            japi.parse_seed(body)
        assert str(got.value) == str(ref.value)


# ------------------------------------------------------- device grammar table

def test_grammar_table_rows_and_refusals_are_the_references(compilers):
    """Registrations in the same order against a budget that holds the
    first three schemas: the same offsets, rows, bytes and refusal, and the
    port's buffer holds the reference's host table in its first rows (the
    rest zeros)."""
    names = ["json_schema-preempt", "regex-int", "json_schema-gateway",
             "json_object", "tool_call-weather"]
    ref_tcs = [compilers[0].compile_spec(SPECS[n]) for n in names]
    got_tcs = [compilers[1].compile_spec(SPECS[n]) for n in names]
    rows = 1 + sum(tc.num_states for tc in ref_tcs[:3])
    # json_object (1734 states) and then the weather tool (58) do not fit
    budget = (rows + 40) * V * 4
    ref = jgrammar.GrammarTables(V, budget_bytes=budget)
    got = grammar.GrammarTables(V, budget_bytes=budget, device="cpu")
    assert got.capacity_rows == rows + 40
    for r, g in zip(ref_tcs, got_tcs):
        assert got.register(g) == ref.register(r)
    assert got.register(got_tcs[0]) == ref.register(ref_tcs[0])  # idempotent
    info = got.info()
    assert {k: info[k] for k in ref.info()} == ref.info()
    assert info["rejected"] == 2
    assert info["allocated_bytes"] == budget
    assert (got.rows, got.nbytes) == (ref.rows, ref.nbytes)
    table = got.table()
    np.testing.assert_array_equal(table[:got.rows].numpy(),
                                  np.asarray(ref.device()))
    assert not table[got.rows:].any()
    with pytest.raises(ValueError, match="vocab mismatch"):
        grammar.GrammarTables(V + 1).register(got_tcs[1])


def test_grammar_refusal_reads_the_state_count_first(compilers):
    """A schema past the budget is refused before its [states, V] table is
    built (the reference builds it, then refuses)."""
    tc = constraint.ConstraintCompiler(ByteTokenizer(V), V).compile_spec(
        SPECS["json_object"])
    tables = grammar.GrammarTables(V, budget_bytes=64 * V * 4)
    assert tables.register(tc) is None
    assert tc._transition is None
    assert tables.info()["allocated_bytes"] == 0


def test_grammar_bias_and_advance_are_the_references(compilers):
    names = ["json_schema-preempt", "json_schema-gateway",
             "tool_call-weather"]
    ref = jgrammar.GrammarTables(V, budget_bytes=4 << 20)
    got = grammar.GrammarTables(V, budget_bytes=4 << 20)
    for n in names:
        assert (got.register(compilers[1].compile_spec(SPECS[n]))
                == ref.register(compilers[0].compile_spec(SPECS[n])))
    rng = np.random.default_rng(3)
    states = rng.integers(0, got.rows, size=(16,)).astype(np.int32)
    states[:3] = 0  # free rows
    ref_table = ref.device()
    tokens = np.asarray([int(rng.choice(np.nonzero(
        np.asarray(ref_table[s]) >= 0)[0])) if rng.random() < 0.8
        else int(rng.integers(0, V)) for s in states], np.int32)
    bias = grammar.grammar_bias(got.table(), torch.from_numpy(states))
    assert bias.dtype == torch.float32
    want = np.asarray(jgrammar.grammar_bias(ref_table, jnp.asarray(states)))
    np.testing.assert_array_equal(bias.numpy(), want)
    assert not bias[:3].any()  # + 0.0 for free rows
    nxt = grammar.grammar_advance(got.table(), torch.from_numpy(states),
                                  torch.from_numpy(tokens))
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(
        nxt.numpy(), np.asarray(jgrammar.grammar_advance(
            ref_table, jnp.asarray(states), jnp.asarray(tokens))))


def test_grammar_budget_env_is_the_references(monkeypatch):
    for raw in ("", "1", "0.5", "junk", "130"):
        monkeypatch.setenv("LLMLB_GRAMMAR_TABLE_MB", raw)
        assert grammar._env_budget_bytes() == jgrammar._env_budget_bytes()
