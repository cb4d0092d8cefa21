"""The port's Smith-Waterman (ops/sw_cuda.py) against the JAX package, on
the CPU.

The DP is exact int32, so every (CIGAR, offset) must be bit-identical:
- the plain torch version against the native aligner (``align``) on SNP,
  insertion, deletion and overhang shapes, alt longer than ref, 1-base
  sequences and pairs of more than 128 diagonals, under every overhang
  strategy and parameter set;
- the batch entry point against the JAX package's Pallas kernel in
  interpret mode, its own tests' CPU route;
- the routes of ``align_batch_cuda`` (shortcut, refs over the cap, batched)
  and their counters;
- realignment with ``use_cuda_sw`` against the native aligner on regions of
  the `call` fixture.
"""
import copy

import numpy as np
import pytest
import torch

from lorikeet_tpu.ops.smith_waterman import (
    ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, NEW_SW_PARAMETERS,
    ORIGINAL_DEFAULT, STANDARD_NGS, OverhangStrategy, align, align_py,
)
from lorikeet_tpu.ops.sw_pallas import align_batch_pallas
from lorikeet_tpu_torch.ops import sw_cuda as sc

BASES = np.frombuffer(b"ACGT", np.uint8)
STRATEGIES = [OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL,
              OverhangStrategy.LEADING_INDEL, OverhangStrategy.IGNORE]
PARAMS = {"original": ORIGINAL_DEFAULT, "ngs": STANDARD_NGS,
          "new": NEW_SW_PARAMETERS,
          "best_hap": ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS}


@pytest.fixture(autouse=True)
def _cpu_sw(monkeypatch):
    monkeypatch.setattr(sc, "SW_DEVICE", "cpu")
    monkeypatch.setattr(sc, "SW_COUNTS", dict.fromkeys(sc.SW_COUNTS, 0))


def _mutate(rng, seq):
    s = bytearray(seq)
    kind = rng.integers(0, 4)
    pos = int(rng.integers(1, max(2, len(s) - 1)))
    if kind == 0:      # SNP
        s[pos] = BASES[(np.searchsorted(BASES, s[pos]) + 1) % 4]
    elif kind == 1:    # deletion
        del s[pos:pos + int(rng.integers(1, 4))]
    elif kind == 2:    # insertion
        s[pos:pos] = bytes(BASES[rng.integers(0, 4, int(rng.integers(1, 4)))])
    else:              # overhang: trim + foreign prefix
        s = bytearray(bytes(BASES[rng.integers(0, 4, 5)])) + s[3:]
    return bytes(s) or b"A"


def _random(rng, n):
    return bytes(BASES[rng.integers(0, 4, n)])


def _cases(rng, n, lo=1, hi=60):
    out = []
    for _ in range(n):
        ref = _random(rng, int(rng.integers(lo, hi)))
        out.append((ref, _mutate(rng, ref)))
    return out


def _native(ref, alt, params, strategy):
    """The native aligner's DP result, also where ``align`` would take the
    exact-substring shortcut (align_py is its no-shortcut mirror)."""
    if strategy in (OverhangStrategy.SOFTCLIP, OverhangStrategy.IGNORE) \
            and ref.rfind(alt) >= 0:
        return align_py(ref, alt, params, strategy)
    return align(ref, alt, params, strategy)


@pytest.mark.parametrize("params", list(PARAMS), ids=list(PARAMS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plain_version_matches_native(strategy, params):
    rng = np.random.default_rng(17 * strategy + len(params))
    p = PARAMS[params]
    pairs = _cases(rng, 24)
    pairs += [(b"ACGTACGTAC", b"GTAC"), (b"ACGTT", b"ACGGTTACG"),
              (b"A", b"C"), (b"A", b"A"), (b"C", b"ACGT"), (b"ACGT", b"G")]
    ref = _random(rng, 150)                        # > 128 diagonals
    pairs += [(ref, _mutate(rng, _mutate(rng, ref))),
              (_random(rng, 40), _random(rng, 100))]
    got = sc.sw_align_torch(sc.to_tensors(sc.pack_pairs(pairs), "cpu"), p,
                            strategy)
    for k, (r, a) in enumerate(pairs):
        assert got[k] == _native(r, a, p, strategy), (k, r, a)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batch_matches_jax_interpret_kernel(strategy):
    rng = np.random.default_rng(5 + strategy)
    # one interpret bucket (ref + alt <= 128): a few seconds to compile
    pairs = _cases(rng, 5, lo=20, hi=50) + [(b"ACGTT", b"ACGGTTACG")]
    p = ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS
    want = align_batch_pallas(pairs, p, strategy, interpret=True)
    assert sc.align_batch_cuda(pairs, p, strategy) == want


def test_routes_and_counters(monkeypatch):
    rng = np.random.default_rng(3)
    p = ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS
    hap = _random(rng, 300)
    inside = hap[100:160]                          # exact substring
    read = hap[40:90] + b"N" + hap[91:140]         # never a substring
    long_ref = _random(rng, sc.MAX_REF_LEN + 1)
    pairs = [(hap, inside), (hap, read), (hap[:200], read),
             (long_ref, long_ref[500:520] + b"N" + long_ref[521:540])]
    # a launch budget of one pair: every batched pair in its own chunk
    monkeypatch.setattr(sc, "SCRATCH_BUDGET", 1)
    launches = sc.SW_LAUNCHES
    got = sc.align_batch_cuda(pairs, p, OverhangStrategy.SOFTCLIP)
    assert got[0] == ([("M", 60)], 100)
    for k, (r, a) in enumerate(pairs):
        assert got[k] == align(r, a, p, OverhangStrategy.SOFTCLIP), k
    assert sc.SW_COUNTS == {"device": 2, "shortcut": 1, "scalar_long": 1}
    assert sc.SW_LAUNCHES == launches          # the CPU runs no kernel
    # INDEL takes no shortcut: the substring pair goes to the batch too
    got = sc.align_batch_cuda(pairs[:2], p, OverhangStrategy.INDEL)
    assert got == [align(r, a, p, OverhangStrategy.INDEL)
                   for r, a in pairs[:2]]
    assert sc.SW_COUNTS["device"] == 4
    # the cap is inclusive: a ref of MAX_REF_LEN bases is batched
    monkeypatch.setattr(sc, "MAX_REF_LEN", len(hap))
    got = sc.align_batch_cuda([(hap, read), (hap + b"A", read)], p)
    assert got == [align(hap, read, p), align(hap + b"A", read, p)]
    assert sc.SW_COUNTS == {"device": 5, "shortcut": 1, "scalar_long": 2}


def test_plain_version_chunks_stay_exact(monkeypatch):
    rng = np.random.default_rng(8)
    pairs = _cases(rng, 12, lo=10, hi=90)
    t = sc.to_tensors(sc.pack_pairs(pairs), "cpu")
    whole = sc.sw_align_torch(t, STANDARD_NGS, OverhangStrategy.IGNORE)
    monkeypatch.setattr(sc, "PLAIN_BT_BUDGET", 1)      # one pair per chunk
    assert sc.sw_align_torch(t, STANDARD_NGS,
                             OverhangStrategy.IGNORE) == whole
    assert whole == [_native(r, a, STANDARD_NGS, OverhangStrategy.IGNORE)
                     for r, a in pairs]


def test_no_silent_host_route(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = [(b"ACGTACGT", b"ACTT")]
    with pytest.raises(RuntimeError, match="CUDA"):
        sc.align_batch_cuda(pairs, ORIGINAL_DEFAULT, device="cuda")
    t = sc.to_tensors(sc.pack_pairs(pairs), "cpu")
    with pytest.raises(ValueError, match="cuda"):
        sc.sw_kernel_launch(t, ORIGINAL_DEFAULT, OverhangStrategy.SOFTCLIP)
    with pytest.raises(ValueError, match="non-empty"):
        sc.pack_pairs([(b"ACGT", b"")])
    with pytest.raises(AssertionError):
        sc.align_batch_cuda([(b"", b"A")], ORIGINAL_DEFAULT)


@pytest.fixture(scope="module")
def realign_inputs(tmp_path_factory):
    """(likelihoods, haplotypes, window_start) of each region of the `call`
    fixture (base errors at 0.01, so that reads reach the SW), captured at
    the realignment step of a native-SW run."""
    from test_torch_call import simulate_fixture

    import lorikeet_tpu_torch.calling.engine as tengine
    import lorikeet_tpu_torch.calling.realign as trealign
    import lorikeet_tpu_torch.processing as tproc
    tmp = tmp_path_factory.mktemp("realign")
    fasta, bams, _ = simulate_fixture(str(tmp), error_rate=0.01)
    seen = []
    real = trealign.realign_reads_to_best_haplotype

    def capture(likelihoods, haplotypes, window_start, use_cuda_sw=False):
        seen.append(copy.deepcopy((likelihoods, haplotypes, window_start)))
        return real(likelihoods, haplotypes, window_start, use_cuda_sw)

    mp = pytest.MonkeyPatch()
    mp.setattr(trealign, "realign_reads_to_best_haplotype", capture)
    try:
        tproc.run_call(fasta, bams, str(tmp / "o"),
                       tengine.CallerConfig(use_cuda=False))
    finally:
        mp.undo()
    return seen


def test_realign_with_device_sw_matches_native(realign_inputs):
    from lorikeet_tpu_torch.calling.realign import (
        realign_reads_to_best_haplotype,
    )
    assert realign_inputs
    for inputs in realign_inputs:
        reads = {}
        for use in (False, True):
            lk, haps, ws = copy.deepcopy(inputs)
            n = realign_reads_to_best_haplotype(lk, haps, ws, use_cuda_sw=use)
            reads[use] = (n, [[(r.pos, r.cigar) for r in lk.reads_by_sample[s]]
                              for s in lk.samples])
        assert reads[True] == reads[False]
    assert sc.SW_COUNTS["device"] >= 20


# ---- the two kernel forms: choice, table order, results in caller order ----

@pytest.mark.parametrize("ref_len,alt_len,form,strip", [
    (1, 1, "warp", 4), (600, 100, "warp", 4), (8191, 128, "warp", 4),
    (40, 129, "warp", 8), (300, 256, "warp", 8), (300, 257, "warp", 16),
    (8191, 511, "warp", 16), (8191, 512, "cta", None),
    (40, 1500, "cta", None), (1, 8191, "cta", None)])
def test_form_choice(ref_len, alt_len, form, strip):
    assert sc.sw_form(ref_len, alt_len) == form
    need = int(sc._scratch_bytes(ref_len, alt_len))
    assert need % 32 == 0
    if form == "warp":
        assert sc.warp_strip(alt_len) == strip and strip * 32 >= alt_len
        steps = ref_len + (alt_len - 1) // strip
        assert need == steps * 32 * strip * 2       # int16 [steps][32][K]
    else:
        cells = (ref_len + 1) * (alt_len + 1) + ref_len + alt_len + 2
        assert 4 * cells <= need < 4 * cells + 32
    # the vector form agrees with the scalar one
    both = sc.sw_form(np.array([ref_len, 7]), np.array([alt_len, 9]))
    assert both.tolist() == [form, "warp"]


def _mixed_pairs(rng, alt_lens):
    pairs = []
    for n in alt_lens:
        ref = _random(rng, n + int(rng.integers(0, 60)))
        alt = bytearray(ref[:n])
        if n >= 8:                            # mutated, then back to n bases
            alt = bytearray(_mutate(rng, _mutate(rng, bytes(alt))))
            alt = (alt + b"T" * n)[:n]
        alt[0:1] = b"N"                       # never an exact substring
        pairs += [(ref, bytes(alt)), (ref[:15], bytes(alt))]
    return pairs


def test_pack_pairs_orders_the_table_by_form():
    rng = np.random.default_rng(12)
    pairs = _mixed_pairs(rng, (600, 5, 520, 40, 511, 512))
    arrays = sc.pack_pairs(pairs)
    meta, order, n_warp = arrays["meta"], arrays["order"], arrays["n_warp"]
    assert sorted(order.tolist()) == list(range(len(pairs)))
    forms = sc.sw_form(meta[:, 1], meta[:, 3]).tolist()
    assert forms == ["warp"] * n_warp + ["cta"] * (len(pairs) - n_warp)
    assert 0 < n_warp < len(pairs)
    # each form keeps the caller's order among its own pairs
    assert order[:n_warp].tolist() == sorted(order[:n_warp].tolist())
    assert order[n_warp:].tolist() == sorted(order[n_warp:].tolist())
    for row, k in enumerate(order.tolist()):
        ref, alt = pairs[k]
        ro, rl, ao, al, so, _ = meta[row].tolist()
        assert bytes(arrays["seqs"][ro:ro + rl]) == ref
        assert bytes(arrays["seqs"][ao:ao + al]) == alt
        assert so % 32 == 0
    # slabs do not overlap, and the maxima are those of each form's rows
    ends = meta[:, 4] + sc._scratch_bytes(meta[:, 1], meta[:, 3])
    assert (meta[1:, 4] >= ends[:-1]).all() and ends[-1] == \
        arrays["scratch_len"]
    assert arrays["warp_max"] == (int(meta[:n_warp, 1].max()) + 1,
                                  int(meta[:n_warp, 3].max()))
    assert arrays["cta_max"] == (int(meta[n_warp:, 1].max()) + 1,
                                 int(meta[n_warp:, 3].max()))
    # one buffer crosses to the device; meta and seqs are views of it
    t = sc.to_tensors(arrays, "cpu")
    assert t["meta"].dtype == torch.int64 and t["seqs"].dtype == torch.uint8
    np.testing.assert_array_equal(t["meta"].numpy(), meta)
    np.testing.assert_array_equal(t["seqs"].numpy(), arrays["seqs"])
    assert t["meta"].untyped_storage().data_ptr() == \
        t["seqs"].untyped_storage().data_ptr()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mixed_batch_matches_native(strategy):
    """Alternates on both sides of the warp form's cap in one batch: the
    table is ordered by form, the results come back in the caller's."""
    rng = np.random.default_rng(40 + strategy)
    pairs = _mixed_pairs(rng, (1, 33, 129, 511, 512, 530))
    p = ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS
    got = sc.align_batch_cuda(pairs, p, strategy)
    assert sc.SW_COUNTS == {"device": len(pairs), "shortcut": 0,
                            "scalar_long": 0}
    for k, (r, a) in enumerate(pairs):
        assert got[k] == align(r, a, p, strategy), (k, len(r), len(a))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mixed_batch_matches_jax_interpret_kernel(strategy, monkeypatch):
    """The same split at a size the interpret kernel compiles quickly: with
    the cap moved to 30 bases a batch of short pairs takes both forms."""
    monkeypatch.setattr(sc, "WARP_MAX_ALT", 30)
    rng = np.random.default_rng(60 + strategy)
    pairs = _mixed_pairs(rng, (45, 8, 31, 30, 50, 3))
    arrays = sc.pack_pairs(pairs)
    assert 0 < arrays["n_warp"] < len(pairs)
    assert arrays["order"].tolist() != list(range(len(pairs)))
    p = ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS
    want = align_batch_pallas(pairs, p, strategy, interpret=True)
    assert sc.align_batch_cuda(pairs, p, strategy) == want
    # split further: one pair a chunk, still the caller's order
    monkeypatch.setattr(sc, "SCRATCH_BUDGET", 1)
    assert sc.align_batch_cuda(pairs, p, strategy) == want


def test_decode_returns_the_callers_order():
    """decode on a hand-made kernel output: rows are in table order."""
    pairs = [(b"ACGTACGTAC", b"N" * 40), (b"ACGTT", b"ACGNT")]
    arrays = sc.pack_pairs(pairs)
    arrays["order"] = np.array([1, 0])          # as if pair 0 were CTA form
    t = sc.to_tensors(arrays, "cpu")
    off = t["meta_host"][:, 5]
    out = np.zeros(4 + arrays["cigar_len"], np.int32)
    out[:4] = [1, 7, 2, 0]                      # (n, offset) per table row
    out[4 + off[0]] = (5 << 4) | 0              # row 0: 5M
    out[4 + off[1]:4 + off[1] + 2] = [(3 << 4) | 4, (9 << 4) | 2]  # 3S 9D
    assert sc.decode(out, t) == [([("S", 3), ("D", 9)], 0), ([("M", 5)], 7)]
