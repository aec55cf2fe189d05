"""The yardstick's counts: from the request's shapes alone, whatever the
plan or the kernel; worked by hand where a value is fixed."""

import pytest

from benchmark import counts, harness

CFG = harness.config(harness.manifest(), "esmdiff-1.4b")


def plan_rows(samples, residues, policy):
    """The real rows of each batch of the port's plan, and each batch's
    pack factor."""
    from esmdiff_tpu_torch.api.generation import bucket_length, plan_batches
    from esmdiff_tpu_torch.ops.packing import pack_factor

    out, left = [], samples
    for B in plan_batches(residues + 2, samples, policy=policy):
        real = min(B, left)
        out.append((real, pack_factor(B, bucket_length(residues + 2))))
        left -= real
    return out


@pytest.mark.parametrize("residues", [58, 118])
def test_sample_count_ignores_plan_and_packing(residues):
    whole = counts.sample_request_flops(CFG, residues, 100, 26, True)
    for policy in ("single", "ladder"):
        rows = plan_rows(100, residues, policy)
        per_batch = sum(counts.sample_request_flops(CFG, residues, real, 26,
                                                    True) for real, _ in rows)
        assert per_batch == pytest.approx(whole, rel=1e-12)
    # bucket 64 packs two rows to a device row; bucket 128 does not
    assert {k for _, k in plan_rows(100, 58, "single")} == {2}
    assert {k for _, k in plan_rows(100, 118, "single")} == {1}


def test_trunk_forward_by_hand():
    # per token: 48 layers of QKV (3 d^2), output (d^2), SwiGLU up
    # (2 d h) and down (h d), d 1536, h 4096; the head's d^2 and d x 4101
    per_token = 48 * (4 * 1536 ** 2 + 3 * 1536 * 4096) \
        + 1536 ** 2 + 1536 * 4101
    n = 120
    want = 2 * n * per_token + 4 * 48 * n * n * 1536
    assert counts.trunk_forward_flops(CFG["trunk"], n) == want


@pytest.mark.parametrize("B,L,H,lengths,want_s", [
    # q, k, v, o in bf16: 4 x 64 x 64 x 24 x 64 x 2 B = 50,331,648 B
    # (+256 B of lengths) at 3.35 TB/s: 15.025 us; FLOPs 1.61e9 / 989e12
    # = 1.63 us, so the bytes bound it
    (64, 64, 24, None, (50_331_648 + 256) / 3.35e12),
    # (64, 128, 24), 112 valid keys: bytes 100,663,296 + 256 -> 30.05 us;
    # FLOPs 4 x 128 x 112 x 64 x 24 x 64 = 5.64e9 -> 5.7 us
    (64, 128, 24, [112] * 64, (100_663_296 + 256) / 3.35e12),
])
def test_flash_bound_by_hand(B, L, H, lengths, want_s):
    assert counts.flash_call_bound_s(B, L, H, 64, lengths) == \
        pytest.approx(want_s, rel=1e-12)


def test_flash_bound_turns_to_flops_when_long():
    # one row of 4096 tokens: FLOPs 4 x 4096^2 x 64 x 24 = 1.03e11 ->
    # 104 us; bytes 4 x 4096 x 24 x 64 x 2 = 50.3 MB -> 15 us
    got = counts.flash_call_bound_s(1, 4096, 24, 64, [4096])
    assert got == pytest.approx(4 * 4096 ** 2 * 64 * 24 / 989e12)


def test_train_count_leaves_out_remat():
    segs = [512, 300, 212, 45]
    fwd = sum(counts.trunk_forward_flops(CFG["trunk"], n)
              + counts.sigma_flops(CFG["trunk"]) for n in segs)
    # forward + backward = 3 forwards; remat's recompute would make it 4
    assert counts.train_step_flops(CFG, segs) == pytest.approx(3 * fwd)
    assert counts.train_step_flops(CFG, segs) < 4 * fwd * 0.99
