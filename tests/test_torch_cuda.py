"""The CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: these need an NVIDIA card and skip without one.  On a
machine with a card run
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
Pair-HMM: each read length below selects another build of the kernel:
register strips of 4, 8 and 16 rows per lane (Rpad 128, 256, 384/512) and
the global-scratch strips of longer reads; the flat kernel (one warp per
pair) runs the same builds, with haplotype slices for 4, 2 and 1 warps per
CTA and in global scratch.  The flat kernel sweeps reads up to 511 bases
in their own class (strips of 1, 2, 4, 8 and 16 rows a lane, a launch a
class present) and longer ones on the scratch strips; each class alone, a
batch of all of them and the grouped kernel's results hold it.  The
grouped kernel gives every warp one read
row: tiles with pad rows, block counts that are not a multiple of 4 and
read lengths 1 to 3,000 run it.  Smith-Waterman: the kernel, its
plain version and the native aligner agree exactly, under every overhang
strategy and parameter set: the warp form at alt lengths on both sides of
its 4-, 8- and 16-column strips against refs of 1 base up to the cap, the
CTA form at ref lengths that cross its 1-, 2-, 4- and 8-rows-per-thread
builds and with alts of 512 and 3,000 bases, and batches that mix both.
"""
import numpy as np
import pytest
import torch

from lorikeet_tpu_torch.ops.smith_waterman import (
    ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS, NEW_SW_PARAMETERS,
    ORIGINAL_DEFAULT, STANDARD_NGS, OverhangStrategy, align,
)
from lorikeet_tpu_torch.ops import pairhmm_cuda as pc
from lorikeet_tpu_torch.ops import sw_cuda as sc
from lorikeet_tpu_torch.ops.pairhmm import (
    F32_SUSPECT_LOG10, pack_pairhmm_batch,
)

pytestmark = pytest.mark.cuda

#: kernel vs torch twin, same f32 sweep on the same card: only expf/log10f
#: and FMA contraction differ; the bound chip_smoke.py holds as well
TOL = 1e-4
#: the flat kernel's classes against the plain version and the grouped
#: kernel: the column schedule rescales at other steps than the
#: anti-diagonal one, exactly (powers of two); log10f of a differently
#: scaled sum and FMA contraction are what differ (chip_smoke.py KERNEL_TOL)
FLAT_TOL = 1e-5
BASES = np.frombuffer(b"ACGTN", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _region(rng, read_len, n_reads=40, n_haps=4):
    hap_len = read_len + int(rng.integers(100, 300))
    ref = BASES[rng.integers(0, 4, hap_len)]
    haps = [ref] + [ref.copy() for _ in range(n_haps - 1)]
    for h in haps[1:]:
        h[rng.integers(0, hap_len, 3)] = BASES[rng.integers(0, 5, 3)]
    pairs = []
    for _ in range(n_reads):
        lo = int(rng.integers(0, hap_len - read_len + 1))
        read = ref[lo:lo + read_len].copy()
        read[rng.integers(0, read_len, 2)] = BASES[rng.integers(0, 5, 2)]
        q = rng.integers(6, 41, read_len).astype(np.uint8)
        iq = rng.integers(20, 46, read_len).astype(np.uint8)
        for h in haps:
            pairs.append((h, read, q, iq, iq, np.full(read_len, 10, np.uint8)))
    return pairs


#: read lengths that select each build of the grouped kernel
KERNEL_READ_LENS = [100, 127, 200, 383, 500, 700, 3000]


def _kernel_batch(read_len):
    """A region of ``read_len``-base reads (40, or 2 past 700 bases) and a
    region of 60-base ones."""
    rng = np.random.default_rng(read_len)
    n_reads = 40 if read_len <= 700 else 2
    return _region(rng, read_len, n_reads) + _region(rng, 60, 7, 2)


@pytest.mark.parametrize("read_len", KERNEL_READ_LENS)
def test_kernel_matches_plain_version(cuda, read_len):
    pairs = _kernel_batch(read_len)
    arrays, out_pos = pc.prepare_grouped_jobs(pairs)
    t = pc.to_tensors(arrays, cuda)
    launches = pc.LAUNCHES
    got = pc.pairhmm_grouped_cuda(t)
    torch.cuda.synchronize()
    assert pc.LAUNCHES == launches + 1
    want = pc.pairhmm_sweep_torch(t)
    pos = torch.from_numpy(out_pos).to(cuda)
    got, want = got[pos].cpu().numpy(), want[pos].cpu().numpy()
    assert np.all(np.isfinite(got))
    keep = want > F32_SUSPECT_LOG10
    assert keep.any()
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=TOL)


def _pad_row_batch(rng, read_len):
    """Regions of 33, 7 and 64 reads against 3, 1 and 2 haplotypes: a few
    reads of ``read_len`` bases (two of them past 512) and, from the same
    reference, short ones for the rest."""
    pairs = []
    for n_reads, n_haps in ((33, 3), (7, 1), (64, 2)):
        n_long = 2 if read_len > 512 else n_reads // 2
        region = _region(rng, read_len, n_long, n_haps)
        haps = [region[k][0] for k in range(n_haps)]
        pairs += region
        for _ in range(n_reads - n_long):
            L = int(rng.integers(1, min(100, read_len) + 1))
            lo = int(rng.integers(0, len(haps[0]) - L + 1))
            read = haps[0][lo:lo + L].copy()
            q = rng.integers(20, 41, L).astype(np.uint8)
            iq = rng.integers(30, 46, L).astype(np.uint8)
            pairs += [(h, read, q, iq, iq, np.full(L, 10, np.uint8))
                      for h in haps]
    return pairs


#: the longest read of each pad-row batch
PAD_ROW_READ_LENS = [1, 31, 100, 255, 511, 512, 3000]


@pytest.mark.parametrize("read_len", PAD_ROW_READ_LENS)
def test_grouped_kernel_pad_rows_and_odd_block_counts(cuda, read_len):
    """Tiles with 31 and 25 pad rows and full ones; 3 * 2 + 1 + 2 * 2 = 11
    table blocks, not a multiple of 4; read lengths from 1 base to
    ``read_len`` in one batch."""
    pairs = _pad_row_batch(np.random.default_rng(7000 + read_len), read_len)
    arrays, out_pos = pc.prepare_grouped_jobs(pairs)
    assert arrays["tile_tab"].size == 11
    assert int((arrays["read_lens"] == 0).sum()) == 31 + 25
    t = pc.to_tensors(arrays, cuda)
    got = pc.pairhmm_grouped_cuda(t)
    torch.cuda.synchronize()
    want = pc.pairhmm_sweep_torch(t)
    pos = torch.from_numpy(out_pos).to(cuda)
    got, want = got[pos].cpu().numpy(), want[pos].cpu().numpy()
    assert np.all(np.isfinite(got))
    keep = want > F32_SUSPECT_LOG10
    assert keep.sum() >= len(pairs) // 3
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=TOL)


def test_grouped_jobs_on_a_side_stream(cuda):
    """The pool service's device half: two jobs enqueued on a stream of its
    own before either is read back give the values of the one-call
    forward on the current stream, bit for bit, one launch each."""
    rng = np.random.default_rng(77)
    batches = [_region(rng, 100) + _region(rng, 250, 9, 3),
               _pad_row_batch(rng, 511)]
    want = [pc.pairhmm_forward_grouped(p, cuda) for p in batches]
    stream = torch.cuda.Stream(cuda)
    launches = pc.LAUNCHES
    handles = [pc.enqueue_grouped_jobs(*pc.prepare_grouped_jobs(p), [cuda],
                                       [stream]) for p in batches]
    assert pc.LAUNCHES == launches + 2
    for handle, w in zip(handles, want):
        got = pc.readback_grouped(handle)
        assert got.dtype == np.float64 and np.array_equal(got, w)


def test_grouped_split_over_the_device_list(cuda):
    """A batch over a device list of two (the first two cards, or the one
    card twice), a stream each: every position launches its share of the
    table blocks and the values are one card's, bit for bit."""
    rng = np.random.default_rng(78)
    pairs = _region(rng, 100) + _region(rng, 250, 9, 3)
    want = pc.pairhmm_forward_grouped(pairs, cuda)
    second = 1 if torch.cuda.device_count() > 1 else 0
    devices = [torch.device("cuda", 0), torch.device("cuda", second)]
    streams = [torch.cuda.Stream(d) for d in devices]
    launches = pc.LAUNCHES
    before = dict(pc.CARD_LAUNCHES)
    got = pc.readback_grouped(pc.enqueue_grouped_jobs(
        *pc.prepare_grouped_jobs(pairs), devices, streams))
    assert pc.LAUNCHES == launches + 2
    assert all(pc.CARD_LAUNCHES.get(i, 0) == before.get(i, 0) + 1
               for i in (0, 1))
    assert got.dtype == np.float64 and np.array_equal(got, want)


def test_kernel_rejects_bad_inputs(cuda):
    pairs = _region(np.random.default_rng(1), 80, 3, 2)
    arrays, _ = pc.prepare_grouped_jobs(pairs)
    t = pc.to_tensors(arrays, cuda)
    t["quals"] = t["quals"].to(torch.int32)
    with pytest.raises(ValueError, match="quals"):
        pc.pairhmm_grouped_cuda(t)


@pytest.mark.parametrize("odd_hmax", [False, True], ids=["even", "odd"])
def test_wire_decode_kernel_matches_plain_version(cuda, odd_hmax):
    """The wire decode on the card gives the plain version's planes byte
    for byte, and they are the flat job's (``haps`` one zero column wider
    when the widest haplotype is odd); one launch.  The grouped kernel on a
    wire job enqueued on a side stream gives the flat job's values bit for
    bit, one decode and one K2 launch."""
    from lorikeet_tpu_torch.ops import pairhmm_pack as pk
    rng = np.random.default_rng(79 + odd_hmax)
    # qualities from a few values, so that the (q, iq, dq, gcp) tuples fit
    # the 256-entry codebook (the random ones of _region do not)
    few, pairs = {}, []
    for hap, read, *_ in _region(rng, 100) + _region(rng, 250, 9, 3):
        if id(read) not in few:
            q = rng.choice([10, 20, 30, 40], len(read)).astype(np.uint8)
            iq = rng.choice([40, 45], len(read)).astype(np.uint8)
            few[id(read)] = (read, q, iq, iq, np.full(len(read), 10, np.uint8))
        pairs.append((hap, *few[id(read)]))
    hmax = max(len(p[0]) for p in pairs)
    if hmax % 2 != odd_hmax:
        pairs.append((BASES[rng.integers(0, 4, hmax + 1)],) + pairs[0][1:])
    flat, out_pos = pk.prepare_grouped_jobs(pairs, wire=False)
    wire, _ = pk.prepare_grouped_jobs(pairs, wire=True)
    width = flat["haps"].shape[1]
    assert wire["mode"] == "wire" and width % 2 == odd_hmax
    t = pc.to_tensors(wire, cuda)
    launches = pc.WIRE_LAUNCHES
    got = pc.wire_decode_cuda(t)
    torch.cuda.synchronize()
    assert pc.WIRE_LAUNCHES == launches + 1
    want = pc.wire_decode_torch(t)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for name in pc._PLANES:
        np.testing.assert_array_equal(got[name].cpu().numpy(), flat[name])
    haps = got["haps"].cpu().numpy()
    assert haps.shape[1] == width + odd_hmax
    np.testing.assert_array_equal(haps[:, :width], flat["haps"])
    assert not haps[:, width:].any()
    values = pc.pairhmm_forward_grouped(pairs, cuda, wire=False)
    launches, k2 = pc.WIRE_LAUNCHES, pc.LAUNCHES
    got = pc.readback_grouped(pc.enqueue_grouped_jobs(
        wire, out_pos, [cuda], [torch.cuda.Stream(cuda)]))
    assert pc.WIRE_LAUNCHES == launches + 1 and pc.LAUNCHES == k2 + 1
    assert got.dtype == np.float64 and np.array_equal(got, values)


def test_wire_decode_rejects_bad_inputs(cuda):
    from lorikeet_tpu_torch.ops import pairhmm_pack as pk
    pairs = _region(np.random.default_rng(3), 80, 3, 2)
    wire, _ = pk.prepare_grouped_jobs(pairs, wire=True)
    t = pc.to_tensors(wire, cuda)
    t["cb"] = t["cb"][:255].contiguous()
    with pytest.raises(ValueError, match="shape"):
        pc.wire_decode_cuda(t)
    t = pc.to_tensors(wire, cuda)
    t["qidx"] = t["qidx"].to(torch.int32)
    with pytest.raises(ValueError, match="qidx"):
        pc.wire_decode_cuda(t)


def _flat_pair(rng, read_len, hap_len):
    hap = BASES[rng.integers(0, 5 if hap_len > 8 else 4, hap_len)]
    if read_len <= hap_len:
        lo = int(rng.integers(0, hap_len - read_len + 1))
        read = hap[lo:lo + read_len].copy()
    else:
        read = BASES[rng.integers(0, 4, read_len)]
    read[rng.integers(0, read_len, 2)] = BASES[rng.integers(0, 5, 2)]
    # long reads get high qualities, so that their likelihood stays above
    # the escalation bound and the comparison keeps them
    q_lo, iq_lo = (6, 20) if read_len < 400 else (33, 42)
    q = rng.integers(q_lo, 41, read_len).astype(np.uint8)
    iq = rng.integers(iq_lo, 46, read_len).astype(np.uint8)
    return (hap, read, q, iq, iq, np.full(read_len, 10, np.uint8))


def _flat_check(cuda, pairs, tol=TOL):
    """Flat kernel == plain version on the kept rows, in input order; one
    launch per class present.  Returns (results, classes)."""
    a = pack_pairhmm_batch(pairs)
    arrays = pc.pack_flat_inputs(
        a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
        a["ins_quals"], a["del_quals"], a["gcps"])
    t = pc.to_tensors(arrays, cuda)
    launches = pc.FLAT_LAUNCHES
    got = pc.pairhmm_flat_cuda(t)
    torch.cuda.synchronize()
    assert pc.FLAT_LAUNCHES == launches + len(arrays["groups"])
    assert got.shape == (len(pairs),)
    want = pc.pairhmm_flat_torch(t)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.all(np.isfinite(got))
    keep = want > F32_SUSPECT_LOG10
    assert keep.sum() >= len(pairs) // 2
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=tol)
    return got, [g[0] for g in arrays["groups"]]


@pytest.mark.parametrize("read_len", [1, 31, 32, 127, 128, 511, 512, 3000])
def test_flat_kernel_matches_plain_version(cuda, read_len):
    """Ragged batches whose size is not a multiple of the 4 warps of a CTA;
    haplotypes from 1 base up, shorter and longer than the read."""
    rng = np.random.default_rng(1000 + read_len)
    n = 37 if read_len <= 512 else 5
    pairs = [_flat_pair(rng, read_len, read_len + int(rng.integers(0, 300)))
             for _ in range(n)]
    pairs += [_flat_pair(rng, max(1, read_len // 2), h)
              for h in (1, 2, 33, read_len + 1)]
    assert len(pairs) % 4
    _flat_check(cuda, pairs)


@pytest.mark.parametrize("kclass", pc.FLAT_CLASSES)
def test_flat_kernel_each_class_alone(cuda, kclass):
    """Reads of one class only, at both of its edges and between, against
    haplotypes of 1 base, shorter than the read, and longer: one launch."""
    rng = np.random.default_rng(2000 + kclass)
    lo, hi = (1, 31) if kclass == 1 else (16 * kclass, 32 * kclass - 1)
    pairs = [_flat_pair(rng, r, h) for r in (lo, (lo + hi) // 2, hi)
             for h in (1, max(1, r // 2), r + 40, 3 * r + 7)]
    pairs += [_flat_pair(rng, hi, hi + 100) for _ in range(6)]
    _, classes = _flat_check(cuda, pairs, tol=FLAT_TOL)
    assert classes == [kclass]


def test_flat_kernel_mixed_classes_in_input_order(cuda):
    """Every class and the scratch strips in one batch, interleaved, with
    duplicate tuples: six launches, results where the pairs stood."""
    rng = np.random.default_rng(2100)
    lens = (600, 1, 255, 40, 511, 100, 31, 64, 128, 256, 32, 3000, 63)
    pairs = [_flat_pair(rng, r, r + int(rng.integers(0, 200)))
             for r in lens for _ in range(3)]
    pairs += [pairs[4], pairs[0], pairs[4]]
    got, classes = _flat_check(cuda, pairs, tol=FLAT_TOL)
    assert classes == [*pc.FLAT_CLASSES, 0]
    np.testing.assert_array_equal(got[-3:], got[[4, 0, 4]])


@pytest.mark.parametrize("hap_len", [5000, 20000, 30000, 60000])
def test_flat_kernel_long_haplotypes(cuda, hap_len):
    """Haplotype slices of 4, 2 and 1 warps per CTA (up to ~14,000, ~28,000
    and ~57,000 bases) and the global-scratch slices past that; a 600-base
    read beside short ones puts the read strips in scratch as well at the
    longest."""
    rng = np.random.default_rng(hap_len)
    reads = (40, 100, 130) + ((600,) if hap_len == 60000 else ())
    pairs = [_flat_pair(rng, r, h) for r in reads
             for h in (hap_len, hap_len // 3, 7)]
    pairs = pairs[:-1] if len(pairs) % 4 == 0 else pairs
    _flat_check(cuda, pairs)


def test_flat_kernel_matches_grouped_kernel(cuda):
    pairs = _region(np.random.default_rng(9), 100, 23, 3) \
        + _region(np.random.default_rng(10), 40, 9, 2) \
        + _region(np.random.default_rng(11), 250, 5, 2)
    flat, classes = _flat_check(cuda, pairs, tol=FLAT_TOL)
    assert classes == [2, 4, 8]
    grouped = pc.pairhmm_forward_grouped(pairs, cuda)
    keep = grouped > F32_SUSPECT_LOG10
    np.testing.assert_allclose(flat[keep], grouped[keep], rtol=0,
                               atol=FLAT_TOL)


def test_flat_kernel_rejects_bad_inputs(cuda):
    pairs = [_flat_pair(np.random.default_rng(2), 50, 80) for _ in range(3)]
    a = pack_pairhmm_batch(pairs)
    arrays = pc.pack_flat_inputs(
        a["haps"], a["hap_lens"], a["reads"], a["read_lens"], a["quals"],
        a["ins_quals"], a["del_quals"], a["gcps"])
    t = pc.to_tensors(arrays, cuda)
    t["hap_lens"] = t["hap_lens"].cpu()
    with pytest.raises(ValueError, match="hap_lens"):
        pc.pairhmm_flat_cuda(t)
    t = pc.to_tensors(arrays, cuda)
    t["quals"] = t["quals"][:, :33].contiguous()
    with pytest.raises(ValueError, match="plane"):
        pc.pairhmm_flat_cuda(t)
    t = pc.to_tensors(arrays, cuda)
    t["groups"] = ((4, 0, 2),)                   # the third pair left out
    with pytest.raises(ValueError, match="groups"):
        pc.pairhmm_flat_cuda(t)
    # 50-base reads put in the 1-row class: the kernel writes NaN, which
    # the escalation rule recomputes, and reads nothing past the strip
    t["groups"] = ((1, 0, 3),)
    got = pc.pairhmm_flat_cuda(t)
    torch.cuda.synchronize()
    assert torch.isnan(got).all()


def _sw_pairs(rng, ref_len, n=6, alt_len=100):
    """Reads of up to ``alt_len`` bases against one random ref, each with
    an N (so never an exact substring), a SNP and a 1-6 bp indel, and one
    read longer than the ref."""
    ref = BASES[rng.integers(0, 4, ref_len)]
    pairs = []
    for _ in range(n):
        ln = min(alt_len, ref_len)
        lo = int(rng.integers(0, ref_len - ln + 1))
        read = bytearray(ref[lo:lo + ln].tobytes())
        read[int(rng.integers(0, ln))] = ord("G")
        k = int(rng.integers(0, len(read) + 1))
        if rng.random() < 0.5:
            read[k:k] = BASES[rng.integers(0, 4, int(rng.integers(1, 7)))
                              ].tobytes()
        else:
            del read[k:k + int(rng.integers(1, 7))]
        read.insert(int(rng.integers(0, len(read) + 1)), ord("N"))
        pairs.append((ref.tobytes(), bytes(read)))
    pairs.append((ref.tobytes(), b"N" + BASES[rng.integers(
        0, 4, ref_len + 20)].tobytes()))
    return pairs


def _sw_check(cuda, pairs, params, strategy, plain=None):
    """Kernel == native aligner on every pair and == plain version on the
    pairs ``plain`` selects (default all); one launch per form present."""
    t = sc.to_tensors(sc.pack_pairs(pairs), cuda)
    launches = sc.SW_LAUNCHES
    got = sc.sw_align(t, params, strategy)
    torch.cuda.synchronize()
    forms = set(sc.sw_form(*np.array([(len(r), len(a)) for r, a in pairs]).T)
                .tolist())
    assert sc.SW_LAUNCHES == launches + len(forms)
    assert got == [align(r, a, params, strategy) for r, a in pairs]
    keep = [k for k, p in enumerate(pairs) if plain is None or plain(*p)]
    t = sc.to_tensors(sc.pack_pairs([pairs[k] for k in keep]), cuda)
    assert [got[k] for k in keep] == sc.sw_align_torch(t, params, strategy)
    return forms


def _sw_alt(rng, ref, alt_len):
    """An alt of exactly ``alt_len`` bases: a mutated stretch of ``ref``
    where it fits, random bases where it does not."""
    ref_len = len(ref)
    if alt_len > ref_len:
        return b"N" + BASES[rng.integers(0, 4, alt_len - 1)].tobytes()
    lo = int(rng.integers(0, ref_len - alt_len + 1))
    alt = bytearray(ref[lo:lo + alt_len])
    if alt_len >= 8:
        k = int(rng.integers(1, alt_len - 4))
        if rng.random() < 0.5:
            alt[k:k] = BASES[rng.integers(0, 4, 3)].tobytes()
        else:
            del alt[k:k + 3]
        alt = (alt + b"ACG")[:alt_len]
        alt[int(rng.integers(0, alt_len))] = ord("G")
    alt[0] = ord("N")
    return bytes(alt)


SW_PARAMS = {"original": ORIGINAL_DEFAULT, "ngs": STANDARD_NGS,
             "new": NEW_SW_PARAMETERS,
             "best_hap": ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS}


@pytest.mark.parametrize("params", list(SW_PARAMS))
@pytest.mark.parametrize("strategy", [
    OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL,
    OverhangStrategy.LEADING_INDEL, OverhangStrategy.IGNORE])
def test_sw_warp_form(cuda, strategy, params):
    """Alt lengths on both sides of every strip width against refs of 1
    base, one short of a 128-row boundary, a realignment haplotype and the
    cap: one launch, all on the warp form.  The plain version is run on the
    refs up to 600 bases (at the cap it takes minutes)."""
    rng = np.random.default_rng(100 * strategy + len(params))
    pairs = []
    for ref_len in (1, 127, 600, sc.MAX_REF_LEN):
        ref = BASES[rng.integers(0, 4, ref_len)].tobytes()
        pairs += [(ref, _sw_alt(rng, ref, alt_len))
                  for alt_len in (1, 31, 32, 33, 127, 128, 129, 511)]
    forms = _sw_check(cuda, pairs, SW_PARAMS[params], strategy,
                      plain=lambda r, a: len(r) <= 600)
    assert forms == {"warp"}


@pytest.mark.parametrize("strategy", [
    OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL,
    OverhangStrategy.LEADING_INDEL, OverhangStrategy.IGNORE])
def test_sw_mixed_batch_and_cta_form_at_512(cuda, strategy):
    """Both forms in one batch, interleaved: two launches, results in the
    caller's order; an alt of 512 bases is the CTA form's shortest."""
    rng = np.random.default_rng(500 + strategy)
    ref = BASES[rng.integers(0, 4, 700)].tobytes()
    pairs = [(ref, _sw_alt(rng, ref, n))
             for n in (512, 100, 700, 511, 1, 513, 256)]
    pairs.append((ref[:40], _sw_alt(rng, ref[:40], 512)))
    assert _sw_check(cuda, pairs, NEW_SW_PARAMETERS, strategy) \
        == {"warp", "cta"}
    only = [p for p in pairs if len(p[1]) == 512]
    assert _sw_check(cuda, only, NEW_SW_PARAMETERS, strategy) == {"cta"}


@pytest.mark.parametrize("ref_len", [1, 127, 128, 129, 600, 1500,
                                     sc.MAX_REF_LEN])
@pytest.mark.parametrize("strategy", [
    OverhangStrategy.SOFTCLIP, OverhangStrategy.INDEL,
    OverhangStrategy.LEADING_INDEL, OverhangStrategy.IGNORE])
def test_sw_kernel_matches_plain_and_native(cuda, strategy, ref_len):
    rng = np.random.default_rng(ref_len + strategy)
    params = (ORIGINAL_DEFAULT, STANDARD_NGS, NEW_SW_PARAMETERS,
              ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS)[strategy]
    n = 2 if ref_len == sc.MAX_REF_LEN else 6
    _sw_check(cuda, _sw_pairs(rng, ref_len, n), params, strategy)


def test_sw_kernel_long_alt(cuda):
    rng = np.random.default_rng(3000)
    pairs = _sw_pairs(rng, 600, n=1) + _sw_pairs(rng, 3200, n=2,
                                                 alt_len=3000)
    _sw_check(cuda, pairs, ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS,
              OverhangStrategy.SOFTCLIP)


def test_sw_kernel_rejects_bad_inputs(cuda):
    p = ALIGNMENT_TO_BEST_HAPLOTYPE_SW_PARAMETERS
    arrays = sc.pack_pairs([(b"ACGTACGT", b"ACTT")])
    t = sc.to_tensors(arrays, cuda)
    t["meta"] = t["meta"].to(torch.int32)
    with pytest.raises(ValueError, match="meta"):
        sc.sw_kernel_launch(t, p, OverhangStrategy.SOFTCLIP)
    t = sc.to_tensors(arrays, cuda)
    t["seqs"] = t["seqs"].cpu()
    with pytest.raises(ValueError, match="want cuda"):
        sc.sw_kernel_launch(t, p, OverhangStrategy.SOFTCLIP)
    t = sc.to_tensors(arrays, cuda)
    out = sc.sw_kernel_launch(t, p, OverhangStrategy.SOFTCLIP)
    assert out.dtype == torch.int32 and out.shape == (2 + arrays["cigar_len"],)
    t["rows_max"] = sc.MAX_REF_LEN + 2
    with pytest.raises(ValueError, match="ref of"):
        sc.sw_kernel_launch(t, p, OverhangStrategy.SOFTCLIP)
    t = sc.to_tensors(arrays, cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sc.sw_kernel_launch(t, p, 7)                  # no such strategy
