"""The port's CUDA kernels against their plain versions, on the card.

Imports no jax, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_cuda.py`` (the suite's conftest imports jax).  Without a card
it skips."""
import pathlib
import sys
from math import prod

import pytest
import torch

from repro_torch.kernels import ops, ref as tref


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    """Each CUDA kernel against its plain version on the card, at small and
    ragged shapes, with launch counting."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).cuda()

    sel = torch.tensor([-1, 0], dtype=torch.int32, device="cuda")
    ops.reset_launches()
    for w, n_words in ((1, 1), (8, 77), (64, 300)):
        d, e, a, b, c = (words(2, w, n_words) for _ in range(5))
        assert torch.equal(ops.beaver_and(d, e, a, b, c, sel),
                           tref.beaver_and(d, e, a, b, c, sel))
        a2, b2, c2, d2, e2 = (words(2, 2 * w, n_words) for _ in range(5))
        opened = words(2, 2, 2 * w, n_words)
        for shift in (s for s in (1, 2, 32) if s < w):   # level shifts < w
            assert torch.equal(ops.ks_mask(d, e, a2, b2, shift),
                               torch.stack(tref.ks_mask(d, e, a2, b2, shift), dim=1))
        args = (d2, opened[:, 0], e2, opened[:, 1], a2, b2, c2, sel, d)
        for u, v in zip(ops.ks_combine(*args), tref.ks_combine(*args)):
            assert torch.equal(u, v)
    for m, k, n in ((1, 1, 1), (70, 33, 65), (2048, 576, 64)):
        x = torch.randint(-2 ** 63, 2 ** 63 - 1, (m, k), generator=gen,
                          dtype=torch.int64).cuda()
        wt = torch.randint(-2 ** 31, 2 ** 31 - 1, (k, n), generator=gen,
                           dtype=torch.int32).cuda()
        assert torch.equal(ops.ring_matmul(x, wt), tref.ring_matmul(x, wt))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"beaver_and": 3, "ks_mask": 5,
                                   "ks_combine": 3, "ks_step": 0, "ks_level": 0,
                                   "cone_step": 0, "ring_matmul": 3,
                                   "ring_matmul_ss": 0, "pack": 0,
                                   "pack_ring": 0, "unpack": 0}


@pytest.mark.cuda
def test_cuda_ks_level_and_bitpack_equal_plain_versions():
    """ks_level in place at strided rows, reading a party-strided AND output,
    pack / pack_ring / unpack at ragged element counts and every width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(1)

    def ints(dtype, *shape):
        info = torch.iinfo(dtype)
        return torch.randint(info.min, info.max, shape, generator=gen,
                             dtype=torch.int64).to(dtype).cuda()

    ops.reset_launches()
    for planes, first, step, n, n_words in ((1, 0, 2, 1, 1), (63, 2, 2, 31, 77),
                                            (7, 6, 4, 1, 300)):
        g, p = ints(torch.int32, 2, planes, n_words), ints(torch.int32, 2, planes, n_words)
        z = ints(torch.int32, 2, 3, 2 * n, n_words)[:, 1]   # party stride 3x
        for u, v in zip(ops.ks_level(g.clone(), p.clone(), z, first, step),
                        tref.ks_level(g.clone(), p.clone(), z, first, step)):
            assert torch.equal(u, v)
    for e in (1, 33, 1000, 70000):
        x = ints(torch.int64, 2, e)
        for k, m in ((64, 0), (21, 13), (45, 12), (22, 13), (14, 13)):
            assert torch.equal(ops.pack_ring(x, k, m), tref.pack_ring(x, k, m))
        v = ints(torch.int32, 3, e)
        for w in (1, 8, 32):
            packed = ops.pack(v, w)
            assert torch.equal(packed, tref.pack(v, w))
            assert torch.equal(ops.unpack(packed, e), tref.unpack(packed, e))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {k: counts[k] for k in ("ks_level", "pack", "pack_ring", "unpack")} \
        == {"ks_level": 3, "pack": 12, "pack_ring": 20, "unpack": 12}


@pytest.mark.cuda
def test_cuda_pack_every_width_and_the_masked_form():
    """The redesigned pack kernel: pack_ring at every w from 1 to 64, plain
    and masked (the A2B round's form), and pack at every w from 1 to 32,
    at E = 1, 31, 33, 1000, 70000 and 262144 (odd E takes one-value
    copies, W % 4 != 0 one-word stores); more rows than one wave of the
    grid holds; inputs and a mask one element off 16-byte alignment (no
    16-byte copies); a mask of the wrong shape or dtype raising.  Each
    output torch.equal to the plain version; exact launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(7)

    def ints(dtype, *shape, offset=0):
        info = torch.iinfo(dtype)
        flat = torch.randint(info.min, info.max, (offset + prod(shape),),
                             generator=gen, dtype=torch.int64).to(dtype).cuda()
        return flat[offset:].view(shape)      # contiguous, offset elements in

    def masks(shape, offset=0):
        return ints(torch.int32, *shape, offset=offset)

    cases = []                                # (x, k, m, mask), (v, w)
    for e in (1, 31, 33, 1000, 70000, 262144):
        x, v = ints(torch.int64, 2, e), ints(torch.int32, 2, e)
        for w in range(1, 65):
            m = 7 * w % (65 - w)                # 0 <= m <= 64 - w, spread
            shape = (2, w, (e + 31) // 32)
            cases += [(x, m + w, m, None), (x, m + w, m, masks(shape))]
            if w <= 32:
                cases.append((v, w))
    # past one wave: an SM holds at most 8 blocks of the 256-thread kernel,
    # so 40 x SMs rows of one tile (8 words) each need more laps
    rows = 40 * torch.cuda.get_device_properties(0).multi_processor_count
    big = ints(torch.int64, rows, 256)
    cases += [(big, 64, 0, None), (big, 21, 13, masks((rows, 8, 8))),
              (ints(torch.int32, rows, 256), 1)]
    # one element off 16-byte alignment: values and mask words
    for e in (64, 1000):
        shape = (2, 8, (e + 31) // 32)
        cases += [(ints(torch.int64, 2, e, offset=1), 21, 13, None),
                  (ints(torch.int64, 2, e, offset=1), 21, 13, masks(shape, offset=1)),
                  (ints(torch.int64, 2, e), 64, 0, masks((2, 64, shape[-1]), offset=1)),
                  (ints(torch.int32, 2, e, offset=1), 5)]
    ops.reset_launches()
    for case in cases:
        if len(case) == 2:
            v, w = case
            assert torch.equal(ops.pack(v, w), tref.pack(v, w)), (tuple(v.shape), w)
        else:
            x, k, m, mask = case
            assert torch.equal(ops.pack_ring(x, k, m, mask=mask),
                               tref.pack_ring(x, k, m, mask)), (tuple(x.shape), k, m)
    torch.cuda.synchronize()
    ring = [c for c in cases if len(c) == 4]
    assert (ops.launch_counts()["pack"], ops.launch_counts()["pack_ring"],
            ops.pack_ring.masked) == (len(cases) - len(ring), len(ring),
                                      sum(c[3] is not None for c in ring))
    x = ints(torch.int64, 2, 1000)
    for bad in (masks((2, 8, 31)), masks((2, 32, 8)).transpose(1, 2),
                torch.zeros((2, 8, 32), dtype=torch.int64, device="cuda")):
        with pytest.raises(ValueError, match="mask must be"):
            ops.pack_ring(x, 21, 13, mask=bad)
    assert ops.launch_counts()["pack_ring"] == len(ring)


def _main_path_matmuls():
    """(M, K, N) of every conv and fc of full-width ResNet-18 on one
    request's stream, from ``chip_smoke.py``'s table."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return tuple((m, k, n) for m, k, n, _ in chip_smoke.RING_MATMUL_SHAPES)


@pytest.mark.cuda
def test_cuda_ring_matmul_main_path_shapes_and_fold():
    """The tensor-core ring_matmul at every shape the main path gives it,
    at ragged shapes, and at K past the int32 accumulators' 16384 (random
    and worst-case digits), against its plain version with full-range
    weights; one launch per call.  At 768 x 768 the output tiles outnumber
    what the card holds at once, so K is not split to fill it, and only
    the fold at 16384 keeps the worst case's int32 sums from wrapping."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(2)
    fold_k = tref.FOLD_K + 128
    cases = []
    for m, k, n in _main_path_matmuls() + ((33, 70, 17), (1, 1, 1), (17, 33, 2),
                                           (2, fold_k, 3), (768, fold_k, 768)):
        x = torch.randint(-2 ** 63, 2 ** 63 - 1, (m, k), generator=gen,
                          dtype=torch.int64)
        x[0, :3] = torch.tensor([0, -1, -0x7f7f7f7f7f7f7f80])[:k]   # 0x00/0xFF/0x80 bytes
        wt = torch.randint(-2 ** 31, 2 ** 31, (k, n), generator=gen,
                           dtype=torch.int64).to(torch.int32)
        wt.view(-1)[:4] = torch.tensor([-2 ** 31, 2 ** 31 - 1, 0, -1],
                                       dtype=torch.int32)[:k * n]
        cases.append((x, wt))
    # every shift's sum at its int32 extreme: all bytes 0xFF, all w digits -128
    for m, n in ((2, 3), (768, 768)):
        cases.append((torch.full((m, fold_k), -1, dtype=torch.int64),
                      torch.full((fold_k, n), 0x7F7F7F80, dtype=torch.int32)))
    ops.reset_launches()
    for x, wt in cases:
        x, wt = x.cuda(), wt.cuda()
        assert torch.equal(ops.ring_matmul(x, wt), tref.ring_matmul(x, wt)), \
            (tuple(x.shape), tuple(wt.shape))
    torch.cuda.synchronize()
    assert ops.launch_counts()["ring_matmul"] == len(cases)


@pytest.mark.cuda
def test_cuda_unpack_shapes_and_merge_routes():
    """The redesigned unpack against its plain version at w = 1, 2, 8, 32;
    n = 0 and n with n % 4 != 0 and n % 32 != 0; 1 to 300 leading rows
    (rows of n % 4 != 0 start off 16-byte alignment and take scalar
    stores) and two leading dims; the four sign-plane shapes.  Then the
    triple merge on the card: the word route equals the bit route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.core import beaver, prng

    gen = torch.Generator().manual_seed(3)
    cases = [((rows,), w, n) for rows in (1, 3, 300) for w in (1, 2, 8, 32)
             for n in (0, 1, 77, 4098, 8209)]
    cases += [((2, 150), 8, 77)] + [((2,), 1, n) for n in chip_smoke.SIGN_PLANES]
    ops.reset_launches()
    for lead, w, n in cases:
        packed = torch.randint(-2 ** 31, 2 ** 31, lead + (w, (n + 31) // 32),
                               generator=gen, dtype=torch.int64).to(torch.int32).cuda()
        assert torch.equal(ops.unpack(packed, n), tref.unpack(packed, n)), (lead, w, n)
    torch.cuda.synchronize()
    assert ops.launch_counts()["unpack"] == sum(1 for _, _, n in cases if n)

    for n, w, cone in ((512, 64, False), (512, 64, True), (4096, 8, True),
                       (256, 1, False)):
        bundles = [beaver.gen_relu_triples(prng.PRNGKey(90 + i, "cuda"), n, w,
                                           cone=cone) for i in range(4)]
        ops.reset_launches()
        words = beaver.concat_relu_triples(bundles, [n] * 4, w, cone=cone)
        assert ops.launch_counts()["unpack"] == 0
        bits = beaver._concat(bundles, [n] * 4, w, cone, beaver._cat_bin_bits)
        assert ops.launch_counts()["pack"] > 0
        for a, b in zip(beaver.relu_tensors(words), beaver.relu_tensors(bits)):
            assert torch.equal(a, b), (n, w, cone)


@pytest.mark.cuda
def test_cuda_ks_step_and_adder_ends_equal_plain_versions():
    """The fused level step against its plain version at w = 2, 8, 64, W =
    1, 77, 1024, 8192 and every level shift below w, with the peer's halves
    as strided views of a received round buffer: one payload of three
    (16-byte aligned, the vector path) and, at W = 1024, one starting a
    word past alignment (the scalar path).  g is updated in place.  The
    adder's two ends too: ks_mask's send buffer, ks_combine without p.
    One launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(4)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).cuda()

    sel = torch.tensor([-1, 0], dtype=torch.int32, device="cuda")
    ops.reset_launches()
    calls = 0
    for w in (2, 8, 64):
        for n_words in (1, 77, 1024, 8192):
            size = 2 * 2 * w * n_words
            received = [words(2, 3, 2, 2 * w, n_words)[:, 1]]
            if n_words == 1024:
                flat = words(2, size + 1)
                received.append(flat[:, 1:].reshape(2, 2, 2 * w, n_words))
            sent = words(2, 2, 2 * w, n_words)
            a, b, c, a2, b2 = (words(2, 2 * w, n_words) for _ in range(5))
            g = words(2, w, n_words)
            for opened in received:
                for shift in (1 << s for s in range(6) if 1 << s < w):
                    args = (sent, opened[:, 0], opened[:, 1], a, b, c, sel)
                    g_k, send_k = ops.ks_step(*args, g.clone(), a2, b2, shift)
                    g_p, send_p = tref.ks_step(*args, g.clone(), a2, b2, shift)
                    assert torch.equal(g_k, g_p) and torch.equal(send_k, send_p), \
                        (w, n_words, shift, opened.stride(0))
                    calls += 1
                halves = (sent[:, 0], opened[:, 0], sent[:, 1], opened[:, 1],
                          a, b, c, sel, g)
                g_only, none = ops.ks_combine(*halves, need_p=False)
                assert none is None
                assert torch.equal(g_only, tref.ks_combine(*halves)[0])
            p = words(2, w, n_words)
            assert torch.equal(ops.ks_mask(g, p, a2, b2, 1),
                               torch.stack(tref.ks_mask(g, p, a2, b2, 1), dim=1))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["ks_step"], counts["ks_mask"], counts["ks_combine"]) == \
        (calls, 12, 15)


@pytest.mark.cuda
def test_cuda_dense_relu_and_offline_pool_equal_cpu():
    """One dense relu at (64, 0) and one at (21, 13) (4096 and 77
    elements) on the card equal the same call on the CPU bit for bit,
    launching ks_mask and ks_combine once and ks_step once per level
    between; an EagerTTP pool (2 requests x 2 streams, dense and cone)
    built on the card equals one built on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import beaver, comm, gmw, prng

    for (k, m), n, steps in (((64, 0), 4096, 5), ((21, 13), 77, 2)):
        outs = {}
        for dev in ("cpu", "cuda"):
            gen = torch.Generator().manual_seed(5)
            x = torch.randint(-2 ** 63, 2 ** 63 - 1, (2, n), generator=gen,
                              dtype=torch.int64).to(dev)
            tri = beaver.gen_relu_triples(prng.PRNGKey(6, dev), n, k - m)
            ops.reset_launches()
            outs[dev] = gmw.relu(prng.PRNGKey(7, dev), x, tri, comm.SimComm(),
                                 k=k, m=m)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert (counts["ks_mask"], counts["ks_step"], counts["ks_combine"]) == \
            (1, steps, 1)
        assert torch.equal(outs["cuda"].cpu(), outs["cpu"])
    specs = [(4096, 8), (77, 0), (0, 8), (1000, 64)]
    for cone in (False, True):
        pools = [beaver.EagerTTP(prng.PRNGKey(8, dev), specs, cone=cone,
                                 requests=2, streams=2) for dev in ("cpu", "cuda")]
        assert pools[0].device_bytes() == pools[1].device_bytes() > 0
        for _ in range(2 * 2 * len(specs)):
            want, got = (p.relu_triples(0, 0) for p in pools)
            assert (want is None) == (got is None)
            if got is not None:
                for u, v in zip(beaver.relu_tensors(got), beaver.relu_tensors(want)):
                    assert u.is_cuda and torch.equal(u.cpu(), v)


def _received(words, rows: int, n_words: int, unaligned: bool):
    """The peer's (P, 2, rows, W) payload as a view of a received round
    buffer: one payload of three (party stride 3x, 16-byte aligned where
    W % 4 == 0), or one starting a word past a (P, 1 + size) buffer
    (every word form, whatever W)."""
    if unaligned:
        flat = words(2, 2 * rows * n_words + 1)
        return flat[:, 1:].reshape(2, 2, rows, n_words)
    return words(2, 3, 2, rows, n_words)[:, 1]


@pytest.mark.cuda
def test_cuda_cone_step_and_opening_beaver_and_equal_plain_versions():
    """cone_step against its plain version at every round of the cone
    adder (the initial AND to the sign plane) at w = 2, 3, 8, 21, 64 and W
    = 1, 77, 1024, 8192 (the stem's; W % 4 != 0 takes the word form), with
    the peer's halves at an aligned and an unaligned party stride (the
    16-byte and the word form where W % 4 == 0); g and p in place.  The
    opening beaver_and likewise at the dense adder's initial AND shapes.
    One launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import gmw

    gen = torch.Generator().manual_seed(6)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                             dtype=torch.int64).to(torch.int32).cuda()

    sel = torch.tensor([-1, 0], dtype=torch.int32, device="cuda")
    ops.reset_launches()
    steps = ands = 0
    for w, n_words in ((2, 77), (3, 1), (8, 1024), (8, 8192), (8, 77),
                       (21, 1024), (64, 8192), (64, 77)):
        levels = gmw._cone_levels(w)
        for unaligned in (False, True):
            g, p = words(2, w - 1, n_words), words(2, w, n_words)
            sent = words(2, 2, w - 1, n_words)
            tri = [words(2, w - 1, n_words) for _ in range(3)]
            level = None
            for r in range(len(levels) + 1):
                rows = sent.shape[2]
                opened = _received(words, rows, n_words, unaligned)
                nxt = ()
                if r < len(levels):
                    lvl, first, step, n = levels[r]
                    nxt_tri = [words(2, 2 * n, n_words) for _ in range(3)]
                    nxt = ((first, step, 1 << lvl), nxt_tri[0], nxt_tri[1])
                args = (sent, opened[:, 0], opened[:, 1], *tri, sel)
                g_p, p_p = g.clone(), p.clone()
                got = ops.cone_step(*args, g, p, level, *nxt)
                want = tref.cone_step(*args, g_p, p_p, level, *nxt)
                assert torch.equal(got, want) and torch.equal(g, g_p) and \
                    torch.equal(p, p_p), (w, n_words, r, unaligned)
                steps += 1
                if nxt:
                    sent, tri, level = got, nxt_tri, (first, step)
            # the opening beaver_and at the dense adder's initial AND
            sent_w = words(2, 2, w, n_words)
            opened = _received(words, w, n_words, unaligned)
            halves = (sent_w[:, 0], sent_w[:, 1], *(words(2, w, n_words)
                                                    for _ in range(3)), sel,
                      opened[:, 0], opened[:, 1])
            assert torch.equal(ops.beaver_and(*halves), tref.beaver_and_open(*halves)), \
                (w, n_words, unaligned)
            ands += 1
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["cone_step"], counts["beaver_and"]) == (steps, ands)


@pytest.mark.cuda
def test_cuda_cone_relu_equals_cpu():
    """The exact-cone and the reduced-cone ReLU (w = 64 over 4096 elements,
    w = 8 over 77) on the card equal the same call on the CPU bit for bit,
    launching one cone_step per round of the adder and no beaver_and or
    ks_level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import beaver, comm, gmw, prng

    for (k, m), n in (((64, 0), 4096), ((21, 13), 77)):
        outs = {}
        for dev in ("cpu", "cuda"):
            gen = torch.Generator().manual_seed(7)
            x = torch.randint(-2 ** 63, 2 ** 63 - 1, (2, n), generator=gen,
                              dtype=torch.int64).to(dev)
            tri = beaver.gen_relu_triples(prng.PRNGKey(8, dev), n, k - m, cone=True)
            ops.reset_launches()
            outs[dev] = gmw.relu(prng.PRNGKey(9, dev), x, tri, comm.SimComm(),
                                 k=k, m=m, cone=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert (counts["cone_step"], counts["beaver_and"], counts["ks_level"]) == \
            (1 + len(gmw._cone_levels(k - m)), 0, 0)
        assert torch.equal(outs["cuda"].cpu(), outs["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("plan_name", ["exact", "reduced-cone"])
def test_cuda_graph_replay_equals_eager_and_cpu(plan_name, monkeypatch):
    """RESNET_SMOKE, 2 sibling streams, an offline pool: the captured
    replay (``HB_ROUND_LOOP=scan``: the signature's first call runs the
    generator loop and captures; then two replays on other inputs) equals
    the generator loop on the card and on the CPU bit for bit; a replay
    launches nothing from the host, its graph holds the eager call's
    launches, its replayed counters equal the schedule, and a result held
    across the next replay is unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import api
    from repro_torch.configs import RESNET_SMOKE
    from repro_torch.core import comm, prng
    from repro_torch.models import resnet

    plan = resnet.trace(resnet.init(RESNET_SMOKE, 0, "cpu"), RESNET_SMOKE, 1, 8,
                        cone=plan_name.endswith("cone"))
    if plan_name.startswith("reduced"):
        plan = plan.with_hb(api.HBConfig(
            (api.HBLayer(k=21, m=13),) * (plan.n_groups - 1)
            + (api.HBLayer(k=13, m=13),), plan.group_elements))
    gen = torch.Generator().manual_seed(11)
    inputs = [[torch.rand((1, 3, 8, 8), generator=gen) * 2 - 1 for _ in range(2)]
              for _ in range(3)]
    sched = plan.schedule(streams=2)

    def run(dev, mode):
        monkeypatch.setenv("HB_ROUND_LOOP", mode)
        cc = comm.CoalescingComm()
        session = api.Session(key=3, comm=cc, device=dev).offline(
            prng.PRNGKey(9, dev), plan, requests=3, streams=2)
        model = api.compile(None, resnet.init(RESNET_SMOKE, 0, dev), RESNET_SMOKE,
                            plan, session)
        calls = []
        for c, xs in enumerate(inputs):
            X = [model.encrypt(prng.PRNGKey(20 + 2 * c + i, dev), x)
                 for i, x in enumerate(xs)]
            r0, b0 = cc.n_rounds, cc.bytes_tx
            ops.reset_launches()
            outs = model(X)
            if dev == "cuda":
                torch.cuda.synchronize()
            counts = ops.launch_counts()
            counts["pack_ring_masked"] = ops.pack_ring.masked
            calls.append({"outs": outs, "held": [o.data.clone() for o in outs],
                          "counts": counts,
                          "comm": (cc.n_rounds - r0, cc.bytes_tx - b0)})
        return model, X, calls

    _, _, cpu = run("cpu", "python")
    _, _, eager = run("cuda", "python")
    model, X, replay = run("cuda", "scan")
    assert model.replay_stats(X)["launches"] == eager[1]["counts"]
    assert replay[0]["counts"] == {k: 2 * v for k, v in eager[0]["counts"].items()}
    for c, (want, got, mine) in enumerate(zip(cpu, eager, replay)):
        assert mine["comm"] == got["comm"] == (sched.n_rounds, sched.bytes_tx)
        if c:
            assert not any(mine["counts"].values())
        for w, g, r, h in zip(want["outs"], got["outs"], mine["outs"], mine["held"]):
            assert torch.equal(g.data.cpu(), w.data)
            assert torch.equal(r.data, g.data)
            assert torch.equal(r.data, h)     # unchanged by the later replays
    assert not torch.equal(replay[1]["outs"][0].data, replay[2]["outs"][0].data)


@pytest.mark.cuda
def test_cuda_ring_matmul_ss_shapes_and_fold():
    """The secret x secret ring matmul against its plain version, bit for
    bit: the LM path's products (16 heads x 2 parties of 8 x 64 @ 64 x 8
    and 8 x 8 @ 8 x 64, and the Beaver combine's K-doubled [E | A] @
    [B ; F]), 512 tokens (512 x 64 @ 64 x 512, 512 x 512 @ 512 x 64, and
    the two Beaver combines at K = 128 and 1024); both forms on each side
    of the wrapper's choice (M = 63 and 64) and at tiles ragged in M, N
    and K (odd K and N take the 8-byte copies); the split-K edges (K =
    4096, 4097, 16 512, and 16 544 where only the 4096 cap cuts K) with every
    byte 0xFF (each shift's largest sum) in both forms; a batch large
    enough that the small form packs 4 cells
    into a block; K = 0; two runs identical, and a CUDA-graph replay equal
    to the eager call, split and unsplit; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(12)

    def ring(*shape):
        return torch.randint(-2 ** 63, 2 ** 63 - 1, shape, generator=gen,
                             dtype=torch.int64).cuda()

    calls = 0

    def check(b, m, k, n, forms=(None,)):
        nonlocal calls
        x, y = ring(b, m, k), ring(b, k, n)
        want = tref.ring_matmul_ss(x, y)
        for form in forms:
            assert torch.equal(ops.ring_matmul_ss(x, y, form=form), want), \
                (b, m, k, n, form)
            calls += 1

    assert (ops.ss_form(63), ops.ss_form(64)) == ("small", "large")
    ops.reset_launches()
    for shape in [(32, 8, 64, 8), (32, 8, 8, 64), (32, 8, 128, 8), (32, 8, 16, 64),
                  (16, 512, 64, 512), (16, 512, 512, 64), (32, 512, 128, 512),
                  (32, 512, 1024, 64), (1, 1, 1, 1), (2048, 8, 64, 8)]:
        check(*shape)
    both = (None, "large", "small")
    for shape in [(3, 63, 70, 64), (3, 64, 70, 64), (2, 63, 96, 9), (2, 64, 96, 9),
                  (3, 33, 70, 31), (2, 65, 97, 67), (2, 130, 100, 66), (4, 7, 33, 70),
                  (2, 129, 33, 130), (1, 200, 1000, 3), (2, 40, 4096 + 4096 + 320, 9)]:
        check(*shape, forms=both)
    # the split's edges; K = 16 544 in more cells than the card holds at
    # once, where only the 4096 cap cuts K (the fold needs shift s's sum
    # only mod 2^(64 - 8s), so without the cap a unit would still be exact
    # up to shift 3's 4 * 255^2 * K < 2^32, K <= 16 512)
    edges = [(b, m, k, n, form) for k in (4096, 4097, 16512)
             for b, m, n, form in ((2, 5, 3, "small"), (1, 64, 64, "large"),
                                   (1, 70, 3, "large"))]
    for b, m, k, n, form in edges + [(2048, 8, 16544, 8, "small"),
                                     (136, 64, 16544, 64, "large")]:
        ones = torch.full((b, m, k), -1, dtype=torch.int64, device="cuda")
        ones_y = torch.full((b, k, n), -1, dtype=torch.int64, device="cuda")
        assert torch.equal(ops.ring_matmul_ss(ones, ones_y, form=form),
                           torch.full((b, m, n), k, dtype=torch.int64, device="cuda")), \
            (b, m, k, n, form)
        calls += 1
        del ones, ones_y
    empty = ops.ring_matmul_ss(ring(2, 3, 0), ring(2, 0, 4))
    assert torch.equal(empty, torch.zeros_like(empty))
    for b, m, k, n in ((1, 64, 16512, 64), (16, 512, 64, 512), (32, 8, 128, 8),
                       (2048, 8, 64, 8)):
        x, y = ring(b, m, k), ring(b, k, n)
        first = ops.ring_matmul_ss(x, y)
        assert torch.equal(ops.ring_matmul_ss(x, y), first), (b, m, k, n)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = ops.ring_matmul_ss(x, y)
        captured.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first), (b, m, k, n)
        assert torch.equal(first, tref.ring_matmul_ss(x, y)), (b, m, k, n)
        calls += 3
    torch.cuda.synchronize()
    assert ops.ring_matmul_ss.launches == calls
    with pytest.raises(ValueError):
        ops.ring_matmul_ss(ring(1, 2, 3), ring(1, 3, 4), form="wide")


@pytest.mark.cuda
def test_cuda_lm_smoke_equals_cpu():
    """One block of the smoke LM (2 sibling streams, exact and per-site
    reduced) through ``compile(...)`` on the card equals the same call on
    the CPU share for share, and launches ring_matmul_ss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch import api, configs
    from repro_torch.core import comm, prng
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b-smoke"), n_layers=1)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    plan = lm.trace(params, cfg, 1, 4)
    gen = torch.Generator().manual_seed(13)
    hs = [torch.randn((1, 4, cfg.d_model), generator=gen) * 0.5 for _ in range(2)]
    for kms in (None, [(22, 0), (22, 6)]):
        run_plan = plan if kms is None else plan.with_hb(api.HBConfig(
            tuple(api.HBLayer(k=k, m=m) for k, m in kms), plan.group_elements))
        outs = {}
        for dev in ("cpu", "cuda"):
            cc = comm.CoalescingComm()
            model = api.compile(None, lm.params_from_jax(_to_numpy(params), dev),
                                cfg, run_plan,
                                api.Session(key=0, comm=cc, device=dev))
            xs = [model.encrypt(prng.PRNGKey(2 + i, dev), h) for i, h in enumerate(hs)]
            ops.reset_launches()
            outs[dev] = model(xs, key=prng.PRNGKey(3, dev))
            sched = run_plan.schedule(streams=2)
            assert (cc.n_rounds, cc.bytes_tx) == (sched.n_rounds, sched.bytes_tx)
        torch.cuda.synchronize()
        assert ops.ring_matmul_ss.launches == 8     # 2 per matmul site and stream
        for a, b in zip(outs["cpu"], outs["cuda"]):
            assert torch.equal(a.data, b.data.cpu())


@pytest.mark.cuda
def test_cuda_lm_long_sequence_large_form_and_chunked_draws_equal_cpu(monkeypatch):
    """One block of the smoke LM on one request of 64 tokens (M = 64: the
    products take ring_matmul_ss's large form, as the 512-token path's do),
    exact and per-site reduced, with the card's threefry cut to chunks of
    4096 words (as the long path's draws are cut at 2^24): every share
    equals the CPU run's, the rounds and bytes the schedule's, and all four
    ring_matmul_ss launches are large."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch import api, configs
    from repro_torch.core import comm, prng
    from repro_torch.models import lm

    monkeypatch.setitem(prng.BITS_CHUNK, "cuda", 4096)
    seq = 64
    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b-smoke"), n_layers=1)
    params = lm.init(cfg, torch.Generator().manual_seed(0))
    plan = lm.trace(params, cfg, 1, seq)
    h = torch.randn((1, seq, cfg.d_model), generator=torch.Generator().manual_seed(14)) * 0.5
    for kms in (None, [(22, 0), (22, 6)]):
        run_plan = plan if kms is None else plan.with_hb(api.HBConfig(
            tuple(api.HBLayer(k=k, m=m) for k, m in kms), plan.group_elements))
        outs = {}
        for dev in ("cpu", "cuda"):
            cc = comm.CoalescingComm()
            session = api.Session(key=0, comm=cc, device=dev)
            session.offline(prng.PRNGKey(7, dev), run_plan)
            model = api.compile(None, lm.params_from_jax(_to_numpy(params), dev),
                                cfg, run_plan, session)
            x = model.encrypt(prng.PRNGKey(2, dev), h)
            ops.reset_launches()
            outs[dev] = model([x], key=prng.PRNGKey(3, dev))
            sched = run_plan.schedule(streams=1)
            assert (cc.n_rounds, cc.bytes_tx) == (sched.n_rounds, sched.bytes_tx)
        torch.cuda.synchronize()
        assert (ops.ring_matmul_ss.launches, ops.ring_matmul_ss.large) == (4, 4)
        for a, b in zip(outs["cpu"], outs["cuda"]):
            assert torch.equal(a.data, b.data.cpu())


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.cuda
def test_cuda_search_forwards_are_deterministic():
    """HummingBird-eco compares logits bit for bit: under the searches'
    ``simulator.deterministic()`` two forwards of full-width ResNet-18 on
    the same batch give ``torch.equal`` logits, and the caller's cuDNN and
    TF32 settings come back after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import RESNET18
    from repro_torch.data import ImagePipeline
    from repro_torch.models import resnet
    from repro_torch.search import simulator

    params = resnet.init(RESNET18, seed=0, device="cuda")
    xs, _ = ImagePipeline(n_classes=10, hw=32).take(64, device="cuda")
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    with simulator.deterministic(), torch.no_grad():
        first = resnet.apply(params, xs, RESNET18)
        for _ in range(3):
            assert torch.equal(resnet.apply(params, xs, RESNET18), first)
    assert (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == saved


@pytest.mark.cuda
def test_cuda_simulated_hb_relu_equals_cpu():
    """The simulator's share split and reduced-ring sign on the card equal
    the CPU's bit for bit, at the stem's full-width shape, w <= 32 and
    w > 32, the exact (64, 0) and the culled width 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import prng
    from repro_torch.search import simulator

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((8, 64, 32, 32), generator=gen) * 3
    for k, m in ((21, 13), (18, 0), (32, 0), (48, 8), (64, 20), (64, 0), (13, 13)):
        cpu = simulator.simulated_hb_relu(x, k, m, prng.PRNGKey(k, "cpu"))
        card = simulator.simulated_hb_relu(x.cuda(), k, m, prng.PRNGKey(k, "cuda"))
        assert card.device.type == "cuda"
        assert torch.equal(card.cpu(), cpu), (k, m)


@pytest.mark.cuda
def test_cuda_rope_tables_equal_the_cpus():
    """The RoPE tables the private LM uses on the card (built on the host,
    then moved) equal the CPU's bit for bit; CUDA's own cosf/sinf would
    not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.nn import rope_tables

    for s, dh, theta in ((8, 64, 1e6), (512, 64, 1e6), (128, 16, 1e4)):
        cpu = rope_tables.rope_tables(s, dh, theta, "cpu")
        card = rope_tables.rope_tables(s, dh, theta, "cuda")
        for a, b in zip(card, cpu):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    angles = torch.arange(512, dtype=torch.float32)[:, None] * torch.rand(32)
    assert torch.equal(rope_tables.sincos_f32(angles.cuda(), True).cpu(),
                       rope_tables.sincos_f32(angles, True))


@pytest.mark.cuda
def test_cuda_finetune_is_reproducible():
    """Two finetunes of full-width ResNet-18 from the same weights, images
    and key give the same params bit for bit on the card (deterministic
    cuDNN and no TF32, as the searches), so a search that follows finds
    the same config on every run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import RESNET18
    from repro_torch.core import prng
    from repro_torch.data import ImagePipeline
    from repro_torch.models import resnet
    from repro_torch.search import finetune

    xs, ys = ImagePipeline(n_classes=10, hw=32).take(128, device="cuda")
    hb = resnet.trace(resnet.init(RESNET18, seed=0, device="cuda"), RESNET18, 1).hb

    def run():
        params = resnet.init(RESNET18, seed=0, device="cuda")
        return finetune.finetune(lambda p, x, relu_fn=None: resnet.apply(
            p, x, RESNET18, relu_fn=relu_fn), params, xs, ys, hb,
            prng.PRNGKey(1, "cuda"), epochs=1, batch=64, lr=3e-3)

    (p1, l1), (p2, l2) = run(), run()
    assert l1 == l2 and len(l1) == 2
    from repro_torch.train.optimizer import tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


class _TinyCfg:
    name = "tiny-mlp-cuda"


def _tiny_apply(params, x, relu_fn=None):
    rf = relu_fn if relu_fn is not None else (lambda v, g: torch.relu(v))
    return rf(rf(x @ params["w1"], 0) @ params["w2"], 1)


def _tiny_forward(params, hs, cfg, relu_fn, comm):
    hs = relu_fn([h.matmul_public(params["w1"]) for h in hs], 0)
    return relu_fn([h.matmul_public(params["w2"]) for h in hs], 1)


@pytest.mark.cuda
def test_cuda_engine_canonical_mix_equals_serial_oracle(monkeypatch):
    """The serving engine on the card (a 2-group MLP, (21, 13) plan) on the
    captured replay: the canonical mix (batches 2, 2, 3 from two tenants)
    as one micro-batch, then the same mix again (a warm replay of the same
    signature); every request's shares equal its serial oracle on the card
    (one stream, ``request_key(id)``, a fresh ``InlineTTP``, the generator
    loop) and the CPU engine's; rounds and bytes equal the prediction.
    Then the pump with three submitting threads, each future waited on
    with a timeout and revealed under ``device_lock``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading

    from repro_torch import api, serve
    from repro_torch.core import beaver, comm, mpc_tensor, prng

    api.register_mpc_forward(_TinyCfg, _tiny_forward)
    gen = torch.Generator().manual_seed(5)
    weights = {"w1": torch.randn((6, 5), generator=gen) * 0.4,
               "w2": torch.randn((5, 4), generator=gen) * 0.4}
    plan = api.trace_plan(_tiny_apply, weights, (2, 6))
    plan = plan.with_hb(api.HBConfig((api.HBLayer(k=21, m=13),) * 2,
                                     plan.group_elements))
    xs = [torch.randn((b, 6), generator=gen) for b in (2, 2, 3)]

    def engine(dev):
        params = {k: v.to(dev) for k, v in weights.items()}
        return serve.InferenceEngine(_tiny_apply, params, _TinyCfg(), plan,
                                     api.Session(key=0, device=dev)), params

    def oracle(x, rid, params):
        monkeypatch.setenv("HB_ROUND_LOOP", "python")
        session = api.Session(key=0, device="cuda")
        model = api.compile(_tiny_apply, params, _TinyCfg(), plan, session)
        enc_key, key = prng.split(session.request_key(rid))
        X = mpc_tensor.MPCTensor.from_plain(enc_key, x.cuda())
        out = model._run_streams([X], [iter(prng.split(key, 256))],
                                 [beaver.InlineTTP()], comm.CoalescingComm(),
                                 params, auto_batch=False)[0]
        monkeypatch.setenv("HB_ROUND_LOOP", "scan")
        return out

    monkeypatch.setenv("HB_ROUND_LOOP", "scan")
    cpu, _ = engine("cpu")
    want_cpu = [cpu.submit(t, x) for t, x in zip(("alice", "bob", "alice"), xs)]
    cpu.flush()
    card, params = engine("cuda")
    for rnd in range(2):
        futs = [card.submit(t, x, request_id=3 * rnd + i)
                for i, (t, x) in enumerate(zip(("alice", "bob", "alice"), xs))]
        card.flush()
        rep = card.reports[-1]
        assert rep.n_requests == 3 and rep.wall_s > 0
        assert (rep.measured_rounds, rep.measured_bytes) == \
            (rep.predicted_rounds, rep.predicted_bytes)
        for i, (f, x) in enumerate(zip(futs, xs)):
            got = f.result().data
            assert got.device.type == "cuda"
            assert torch.equal(got, oracle(x, 3 * rnd + i, params).data)
            if rnd == 0:
                assert torch.equal(got.cpu(), want_cpu[i].result().data)
    card.start_pump(interval_s=0.002, max_wait_s=0.02)
    try:
        got = {}

        def client(i):
            fut = card.submit("carol", xs[i], request_id=10 + i)
            out = fut.result(timeout_s=120.0)
            with card.device_lock:
                got[i] = out.data.cpu()

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
            assert not t.is_alive()
        assert card.last_pump_error is None
    finally:
        card.stop_pump()
    for i, x in enumerate(xs):
        assert torch.equal(got[i], oracle(x, 10 + i, params).data.cpu())


@pytest.mark.cuda
def test_cuda_two_party_threads_equal_simcomm(monkeypatch):
    """RESNET_SMOKE's reduced plan as two parties in two threads over
    localhost ``Session.connect``, each holding one party's rows (every
    ReLU kernel at a local party dimension of 1): the combined output
    equals the ``SimComm`` generator-loop run on the card with the same
    shares, pool and key, and the CPU run; both parties' framed rounds and
    bytes equal ``Schedule.framed()``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import threading

    from repro_torch import api
    from repro_torch.configs import RESNET_SMOKE
    from repro_torch.core import beaver, comm as comm_lib, prng
    from repro_torch.core.mpc_tensor import MPCTensor
    from repro_torch.models import resnet
    from repro_torch.transport import free_port

    monkeypatch.setenv("HB_ROUND_LOOP", "python")
    params = resnet.init(RESNET_SMOKE, seed=0, device="cpu")

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn)

    plan = api.trace_plan(afn, params, (2, 3, 8, 8), name="smoke")
    plan = plan.with_hb(api.HBConfig(
        tuple([api.HBLayer(k=21, m=13)] * (plan.n_groups - 1)
              + [api.HBLayer(k=13, m=13)]), plan.group_elements))

    def sim(device):
        p = resnet._map_paths(lambda _, t: t.to(device), params)
        x = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(1)) * 0.5
        X = MPCTensor.from_plain(prng.PRNGKey(2, device), x.to(device))
        pool = beaver.gen_plan_triples(prng.PRNGKey(3, device), plan.triple_specs())
        model = api.compile(afn, p, RESNET_SMOKE, plan,
                            api.Session(key=0, device=device,
                                        provider=beaver.TriplePool(pool)))
        return p, X, pool, model(X, key=prng.PRNGKey(4, device)).data

    want_cpu = sim("cpu")[3]
    p, X, pool, want = sim("cuda")
    port, res = free_port(), {}

    def party(i):
        session = api.Session.connect(
            i, listen=("127.0.0.1", port) if i == 0 else None,
            peer=("127.0.0.1", port) if i == 1 else None, key=0,
            session_id="cuda", plan_digest=plan.digest(), device="cuda",
            provider=beaver.TriplePool(beaver.slice_party_pool(pool, i)),
            timeout_s=120.0, handshake_timeout_s=120.0)
        model = api.compile(afn, p, RESNET_SMOKE, plan, session)
        res[i] = (model(MPCTensor(X.data[i:i + 1], X.frac_bits),
                        key=prng.PRNGKey(4, "cuda")).data, session)

    threads = [threading.Thread(target=party, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
        assert not t.is_alive()
    got = torch.cat([res[0][0], res[1][0]])
    assert torch.equal(got, want) and torch.equal(got.cpu(), want_cpu)
    framed = plan.schedule().framed()
    for i in (0, 1):
        sess = res[i][1]
        assert sess.transport.round_bytes == list(framed.round_bytes)
        assert comm_lib.find_resilient(sess.comm).round_bytes == \
            list(framed.round_bytes)
        sess.transport.close()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["python", "scan"])
def test_cuda_smoke_mesh_step_equals_serve_step(mode, monkeypatch):
    """RESNET_SMOKE's reduced plan through ``jit_step`` on the smoke mesh
    (party axis of size 1: ``CoalescingComm(MeshComm)``, local flips), with
    and without the data axis (``shard_pool(pool, 1)``), on the card: bit
    for bit ``serve_step(None)`` on the card and the CPU run, on either
    round loop (``scan``: the captured replay), its counters the schedule
    round for round, and so its census on the generator loop (the replay's
    graph holds the flips: its census stays empty)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import api
    from repro_torch.configs import RESNET_SMOKE
    from repro_torch.core import beaver, prng
    from repro_torch.core.mpc_tensor import MPCTensor
    from repro_torch.launch.mesh import make_mpc_smoke_mesh
    from repro_torch.models import resnet

    monkeypatch.setenv("HB_ROUND_LOOP", mode)
    params = resnet.init(RESNET_SMOKE, seed=0, device="cpu")

    def afn(p, v, relu_fn=None):
        return resnet.apply(p, v, RESNET_SMOKE, relu_fn=relu_fn)

    plan = api.trace_plan(afn, params, (2, 3, 8, 8), name="smoke")
    plan = plan.with_hb(api.HBConfig(
        tuple([api.HBLayer(k=21, m=13)] * (plan.n_groups - 1)
              + [api.HBLayer(k=13, m=13)]), plan.group_elements))
    sched = plan.schedule()

    def run(device):
        p = resnet._map_paths(lambda _, t: t.to(device), params)
        x = torch.randn((2, 3, 8, 8), generator=torch.Generator().manual_seed(1)) * 0.5
        X = MPCTensor.from_plain(prng.PRNGKey(2, device), x.to(device))
        pool = beaver.gen_plan_triples(prng.PRNGKey(3, device), plan.triple_specs())
        model = api.compile(afn, p, RESNET_SMOKE, plan, api.Session(key=0, device=device))
        key = prng.PRNGKey(4, device)
        want = model.serve_step()(p, X.data, pool, key)
        mesh = make_mpc_smoke_mesh(device)
        for data_axis, triples in ((None, pool), ("data", beaver.shard_pool(pool, 1))):
            step = model.jit_step(mesh, data_axis=data_axis)
            for _ in range(2):
                got = step(p, X.data, triples, key)
                assert torch.equal(got, want)
                assert step.comm.round_bytes == list(sched.round_bytes)
                assert [(c.count, c.bytes) for c in step.census] == (
                    [(1, b) for b in sched.round_bytes] if mode == "python" else [])
        return want

    assert torch.equal(run("cuda").cpu(), run("cpu"))


@pytest.mark.cuda
def test_cuda_leakage_census_equals_cpu():
    """The leakage census (``analysis.census``) on the card: RESNET_SMOKE's
    exact and reduced ``serve_step`` at input (2, 3, 8, 8), every wire round
    classed element by element exactly as on the CPU from the same seeds,
    zero unmasked rounds, and the rounds and bytes of the schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.analysis import census
    from repro_torch.configs import RESNET_SMOKE

    got = census.resnet_census(RESNET_SMOKE, 2, 8, "cuda", ("exact", "reduced"))
    want = census.resnet_census(RESNET_SMOKE, 2, 8, "cpu", ("exact", "reduced"))
    for name in ("exact", "reduced"):
        s = got[name]
        assert s["unmasked_collectives"] == 0 and s["cross_check_ok"], s
        assert s["collectives"] == s["sched_rounds"] > 0
        assert s["rounds"] == want[name]["rounds"]


def _tree_to(tree, device):
    """A copy of the tree on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "mixtral-8x22b", "falcon-mamba-7b",
                                  "zamba2-2.7b", "internvl2-76b",
                                  "seamless-m4t-medium"])
def test_cuda_zoo_smoke_equals_cpu(name):
    """One smoke architecture per family of the plaintext zoo (dense, MoE,
    SSM, hybrid, VLM, enc-dec) on the card against the same call on the
    CPU, from the same weights and inputs, TF32 off: ``apply``,
    ``prefill`` and one ``decode_step`` (on both from the CPU's prefill
    cache: a bfloat16 K/V rounded one ulp apart moves the logits by up to
    3e-4) within 1e-4 (float32, other summation orders), 8 greedy tokens
    (each from its own cache) equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import encdec, lm

    cfg = configs.get(name + "-smoke")
    model = encdec if cfg.family == "encdec" else lm
    params = model.init(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    b, s, steps = 2, 24, 8
    n_fe = cfg.n_frontend_tokens if cfg.frontend != "none" else 0
    src = torch.randn((b, s, cfg.d_model), generator=gen)
    fe = torch.randn((b, n_fe, cfg.d_model), generator=gen) if n_fe else None
    tokens = torch.randint(0, cfg.vocab, (b, s - n_fe), generator=gen)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        outs, cpu_cache = {}, None
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev)
            step = serve.make_decode_step(cfg)
            if cfg.family == "encdec":
                first = tokens[:, :1].to(dev)
                out = [encdec.apply(p, src.to(dev), tokens.to(dev), cfg)]
                cache = serve.make_prefill_step(cfg, s + steps)(p, src.to(dev))
                pos = 0
            else:
                first = tokens[:, -1:].to(dev)
                ext = torch.cat([tokens, tokens[:, -1:]], dim=1).to(dev)
                out = [lm.apply(p, ext, cfg, None if fe is None else fe.to(dev))]
                lg, cache = serve.make_prefill_step(cfg, s + steps)(
                    p, tokens.to(dev), None if fe is None else fe.to(dev))
                out.append(lg)
                pos = s
            cpu_cache = _tree_to(cache, "cpu") if cpu_cache is None else cpu_cache
            out.append(step(p, first, _tree_to(cpu_cache, dev), pos)[0])
            greedy, _ = serve.greedy_decode_loop(p, cfg, cache, first, pos, steps)
            outs[dev] = ([o.cpu() for o in out], greedy.cpu())
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for got, want in zip(outs["cuda"][0], outs["cpu"][0]):
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), \
            float((got - want).abs().max())
    assert torch.equal(outs["cuda"][1], outs["cpu"][1]), \
        (outs["cuda"][1].tolist(), outs["cpu"][1].tolist())


@pytest.mark.cuda
def test_cuda_train_step_equals_cpu_and_checkpoint_restores_on_the_cpu(tmp_path):
    """A smoke train step (qwen1.5-0.5b-smoke, 2 layers, float32, remat
    "dots", AdamW) on the card against the same step on the CPU: loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its largest CPU
    magnitude (chip_smoke.py's train phase (c) tolerances), none of the
    port's kernels launched; then the card's checkpoint of the new state
    restored onto the CPU, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch import configs
    from repro_torch.checkpoint import store
    from repro_torch.data import TokenPipeline
    from repro_torch.launch import train as train_lib
    from repro_torch.train import loop as loop_lib, optimizer as opt_lib

    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b-smoke"), n_layers=2, remat="dots")
    opt = opt_lib.AdamW()
    state = train_lib.init_state(cfg, opt, torch.Generator().manual_seed(0))
    batch = TokenPipeline(cfg.vocab, 32, 4).batch_at(0, device="cpu")
    ops.reset_launches()
    out = {}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            params = opt_lib.tree_map(
                lambda p: p.to(dev, copy=True).requires_grad_(True), state.params)
            loss, grads = train_lib.value_and_grad(
                params, {k: v.to(dev) for k, v in batch.items()}, cfg)
            out[dev] = (float(loss), [g.cpu() for g in grads])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert not any(ops.launch_counts().values())
    (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, c in zip(g_card, g_cpu):
        assert float((a - c).abs().max()) <= 1e-4 * float(c.abs().max())

    card_state = train_lib.TrainState(
        opt_lib.tree_map(lambda p: p.cuda(), state.params),
        opt_lib.tree_map(lambda p: p.cuda(), state.opt_state), state.step)
    new, _ = train_lib.make_train_step(cfg, opt)(card_state, {k: v.cuda() for k, v
                                                              in batch.items()})
    store.save(str(tmp_path), 1, new)
    back, _ = loop_lib.elastic_restore(str(tmp_path), cfg, opt, device="cpu")
    for a, b in zip(opt_lib.tree_leaves(new.params) + opt_lib.tree_leaves(new.opt_state),
                    opt_lib.tree_leaves(back.params) + opt_lib.tree_leaves(back.opt_state)):
        assert b.device.type == "cpu" and torch.equal(a.cpu(), b)
    assert int(back.step) == 1
