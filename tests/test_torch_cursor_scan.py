"""The staged scan of the port's hash tables (`lp_probe`, `csr_probe`,
`scan_next`, `scan_match`, `scan_gather`, `scan_advance`) against the JAX
package's on the same seeded tables and keys: cursors, ends, sel, counts,
matched rows and gathered keys and payloads equal, step by step until the
scan drains. The port's counts are host ints when given one, and count
tensors for a batch of chunks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccve_tpu.ops import hash_table as jht
from ccve_tpu_torch.core.datagen import gen_rhs_table
from ccve_tpu_torch.ops import hash_table as tht

BLOCK = 128
RHS = 96


def _tables(kind, chunk_factor, n_rhs=RHS):
    keys, payloads = gen_rhs_table(n_rhs, chunk_factor)
    jb, tb = (jht.build_lp, tht.build_lp) if kind == "lp" else (jht.build_csr, tht.build_csr)
    return jb(keys, payloads), tb(keys, payloads, device="cpu"), keys


def _chunk(rng, count, stale="random", dom=2 * RHS):
    """Probe keys int64[BLOCK] (about half in the table's domain), a sorted
    selection of `count` rows, and stale entries past count: random valid
    rows, or zeros (as a compaction leaves them)."""
    keys = rng.integers(0, dom, BLOCK).astype(np.int64)
    sel = np.sort(rng.choice(BLOCK, count, replace=False)).astype(np.int32)
    tail = (rng.integers(0, BLOCK, BLOCK - count) if stale == "random"
            else np.zeros(BLOCK - count)).astype(np.int32)
    return keys, np.concatenate([sel, tail])


def _eq(name, got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want.astype(got.dtype)), name


def _same_state(t: tht.ScanState, j: jht.ScanState, what: str):
    assert isinstance(t.count, int) and t.count == int(j.count), what
    for field in ("cursor", "end", "sel"):
        _eq(f"{what}: {field}", getattr(t, field), getattr(j, field))


def _probe(kind, jt, tt, keys, sel, count):
    jprobe, tprobe = (jht.lp_probe, tht.lp_probe) if kind == "lp" else (jht.csr_probe,
                                                                         tht.csr_probe)
    js = jprobe(jt, jnp.asarray(keys), jnp.asarray(sel), jnp.asarray(count, jnp.int32))
    ts = tprobe(tt, torch.from_numpy(keys), torch.from_numpy(sel), count)
    _same_state(ts, js, f"{kind} probe")
    return js, ts


def _drain(kind, jt, tt, keys, js, ts, want_matches=True):
    """Step both scans until they drain; returns the steps and matches."""
    jk, tk = jnp.asarray(keys), torch.from_numpy(keys)
    steps = matches = 0
    while ts.count:
        jr = jht.scan_next(jt, jk, js, want_matches=want_matches)
        tr = tht.scan_next(tt, tk, ts, want_matches=want_matches)
        what = f"{kind} step {steps}"
        assert tr.result_count == int(jr.result_count), what
        _eq(f"{what}: result_vector", tr.result_vector, jr.result_vector)
        if want_matches:
            _eq(f"{what}: matched_keys", tr.matched_keys, jr.matched_keys)
            _eq(f"{what}: matched_payloads", tr.matched_payloads, jr.matched_payloads)
        else:  # JAX gives zeros, the port nothing
            assert tr.matched_keys is None and tr.matched_payloads is None
            assert not np.asarray(jr.matched_keys).any()
        _same_state(tr.state, jr.state, what)
        matches += tr.result_count
        js, ts = jr.state, tr.state
        steps += 1
        assert steps <= max(getattr(tt, "max_run", 0), getattr(tt, "max_len", 0)) + 1
    assert int(js.count) == 0
    return steps, matches


@pytest.mark.parametrize("kind", ["lp", "csr"])
@pytest.mark.parametrize("chunk_factor", [1, 2, 3, 4])
def test_probe_and_next_match_jax(kind, chunk_factor):
    """A sparse selection with random stale entries past count: every
    probe and Next equals JAX's, and the matches equal a numpy count."""
    jt, tt, build = _tables(kind, chunk_factor)
    rng = np.random.default_rng(chunk_factor)
    for count, stale in ((BLOCK, "random"), (77, "random"), (40, "zeros"), (0, "random")):
        keys, sel = _chunk(rng, count, stale)
        js, ts = _probe(kind, jt, tt, keys, sel, count)
        _, matches = _drain(kind, jt, tt, keys, js, ts)
        live = keys[sel[:count]]
        assert matches == int((live[:, None] == build[None, :]).sum())


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_count_only_next_skips_the_gather(kind):
    jt, tt, _ = _tables(kind, 2)
    keys, sel = _chunk(np.random.default_rng(5), 100)
    js, ts = _probe(kind, jt, tt, keys, sel, 100)
    _drain(kind, jt, tt, keys, js, ts, want_matches=False)
    r = tht.scan_next(tt, torch.from_numpy(keys), ts, want_matches=False)
    assert r.matched_keys is None and r.matched_payloads is None


def test_stale_entries_mark_no_live_row():
    """A state whose sel repeats live rows and names dead ones past count:
    the live mask, the matches and the survivors come from the first count
    entries only, in both packages."""
    jt, tt, _ = _tables("csr", 3)
    keys, sel = _chunk(np.random.default_rng(11), 30)
    js, ts = _probe("csr", jt, tt, keys, sel, 30)
    stale = np.random.default_rng(12).integers(0, BLOCK, BLOCK - ts.count).astype(np.int32)
    tsel = ts.sel.numpy().copy()
    tsel[ts.count:] = stale
    ts = ts._replace(sel=torch.from_numpy(tsel))
    js = js._replace(sel=jnp.asarray(tsel))
    live = tht._scan_live_mask(ts, BLOCK).numpy()
    assert np.array_equal(np.nonzero(live)[0], np.sort(tsel[: ts.count]))
    _eq("live mask", live, jht._scan_live_mask(js, BLOCK))
    _drain("csr", jt, tt, keys, js, ts)


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_phases_alone_match_jax(kind):
    """scan_match, scan_gather and scan_advance (the micro-benchmark's
    attribution) against JAX's, round after round, and together equal to
    scan_next."""
    jt, tt, _ = _tables(kind, 4)
    keys, sel = _chunk(np.random.default_rng(3), 120)
    js, ts = _probe(kind, jt, tt, keys, sel, 120)
    jk, tk = jnp.asarray(keys), torch.from_numpy(keys)
    while ts.count:
        jrv, jrc = jht.scan_match(jt, jk, js)
        trv, trc = tht.scan_match(tt, tk, ts)
        assert trc == int(jrc)
        _eq("match", trv, jrv)
        jg, tg = jht.scan_gather(jt, js, jrv), tht.scan_gather(tt, ts, trv)
        _eq("gather keys", tg[0], jg[0])
        _eq("gather payloads", tg[1], jg[1])
        fused = tht.scan_next(tt, tk, ts)
        _eq("fused keys", fused.matched_keys[:trc], tg[0][:trc])
        _eq("fused payloads", fused.matched_payloads[:trc], tg[1][:trc])
        js, ts = jht.scan_advance(jt, js), tht.scan_advance(tt, ts)
        _same_state(ts, js, f"{kind} advance")
        _same_state(ts, fused.state, f"{kind} advance against next")


def test_chain_at_max_len():
    """Probes of the keys of the longest bucket drain in exactly max_len
    steps, each finding its matches, as JAX's."""
    jt, tt, build = _tables("csr", 4, n_rhs=200)
    offsets = tt.offsets.numpy()
    lengths = np.diff(offsets)
    b = int(lengths.argmax())
    assert lengths[b] == tt.max_len and tt.max_len >= 4
    bucket_keys = tt.entry_keys.numpy()[offsets[b]:offsets[b + 1]]
    keys = np.resize(bucket_keys, BLOCK).astype(np.int64)
    sel = np.arange(BLOCK, dtype=np.int32)
    js, ts = _probe("csr", jt, tt, keys, sel, BLOCK)
    steps, matches = _drain("csr", jt, tt, keys, js, ts)
    assert steps == tt.max_len
    assert matches == int((keys[:, None] == build[None, :]).sum())


def test_lp_cursor_wraps():
    """An LP chain that runs past the last slot continues at slot 0."""
    tt = tht.build_lp(np.arange(8, dtype=np.int64), device="cpu")
    n = tt.n_slots
    last = n - 1
    state = tht.ScanState(cursor=torch.full((BLOCK,), last, dtype=torch.int64),
                          end=torch.full((BLOCK,), -1, dtype=torch.int64),
                          sel=torch.arange(BLOCK, dtype=torch.int32), count=3)
    nxt = tht.scan_advance(tt, state)
    assert int(nxt.cursor.max()) == 0 and int(nxt.cursor.min()) == 0
    assert nxt.count == (3 if int(tt.slot_keys[0]) != tht.EMPTY else 0)


def test_empty_csr_table():
    """An empty table: every probe drops every row, as in JAX, and a Next
    over a state that claims live rows neither raises nor matches."""
    jt, tt, _ = _tables("csr", 1, n_rhs=0)
    keys, sel = _chunk(np.random.default_rng(0), 64)
    js, ts = _probe("csr", jt, tt, keys, sel, 64)
    assert ts.count == 0
    claimed = ts._replace(sel=torch.arange(BLOCK, dtype=torch.int32), count=BLOCK,
                          end=torch.ones(BLOCK, dtype=torch.int64))
    r = tht.scan_next(tt, torch.from_numpy(keys), claimed)
    assert r.result_count == 0 and not r.matched_keys.any()
    assert tht.scan_match(tt, torch.from_numpy(keys), claimed)[1] == 0
    assert tht.scan_advance(tt, claimed).count == 0


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_batched_chunks_equal_one_by_one(kind):
    """A batch of chunks ([C, block], count tensors, no host read) scans
    as each chunk alone does."""
    _, tt, _ = _tables(kind, 2)
    rng = np.random.default_rng(9)
    counts = [BLOCK, 50, 0, 99]
    chunks = [_chunk(rng, c) for c in counts]
    keys = torch.from_numpy(np.stack([k for k, _ in chunks]))
    sel = torch.from_numpy(np.stack([s for _, s in chunks]))
    probe = tht.lp_probe if kind == "lp" else tht.csr_probe
    batch = probe(tt, keys, sel, torch.tensor(counts, dtype=torch.int32))
    singles = [probe(tt, keys[i], sel[i], c) for i, c in enumerate(counts)]
    for _ in range(tt.max_run if kind == "lp" else tt.max_len):
        assert batch.count.tolist() == [s.count for s in singles]
        for i, s in enumerate(singles):
            _eq("batch cursor", batch.cursor[i], s.cursor)
            _eq("batch sel", batch.sel[i], s.sel)
        rb = tht.scan_next(tt, keys, batch)
        rs = [tht.scan_next(tt, keys[i], s) for i, s in enumerate(singles)]
        assert rb.result_count.tolist() == [r.result_count for r in rs]
        for i, r in enumerate(rs):
            _eq("batch matches", rb.matched_keys[i], r.matched_keys)
        batch, singles = rb.state, [r.state for r in rs]
    assert not batch.count.any()


@pytest.mark.parametrize("kind", ["lp", "csr"])
def test_identity_selection(kind):
    """sel None probes every row in order, as the identity sel does."""
    _, tt, _ = _tables(kind, 2)
    keys = torch.from_numpy(_chunk(np.random.default_rng(4), BLOCK)[0])
    probe = tht.lp_probe if kind == "lp" else tht.csr_probe
    for count in (BLOCK, 70, 0):
        a = probe(tt, keys, None, count)
        b = probe(tt, keys, torch.arange(BLOCK, dtype=torch.int32), count)
        assert a.count == b.count
        for field in ("cursor", "end", "sel"):
            _eq(field, getattr(a, field), getattr(b, field))
