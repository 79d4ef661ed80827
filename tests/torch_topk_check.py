"""Top-k comparison up to ties, shared by the arec_torch parity tests.

lax.top_k and torch.topk may order exact or near ties differently, and two
f32 sums in different orders may swap neighbours whose scores differ in
the last bits. So a port's top-k agrees with arec's when its scores are
allclose to arec's, rank by rank, and the id it returns at each rank has
(in a float64 reference of the same masked scores) the score arec reports
at that rank."""

import numpy as np


def ref_scores(query, latents, bias, seen, round_to_bf16=True):
    """float64 masked scores [B, V] from the operands both sides multiply:
    bf16-rounded query and latents, f32 bias, −1e9 per seen occurrence."""
    import torch

    def rnd(a):
        t = torch.as_tensor(np.asarray(a, np.float32))
        if round_to_bf16:
            t = t.to(torch.bfloat16).float()
        return t.numpy().astype(np.float64)

    scores = rnd(query) @ rnd(latents).T + np.asarray(bias, np.float64)
    seen = np.asarray(seen)
    rows = np.broadcast_to(np.arange(seen.shape[0])[:, None], seen.shape)
    ok = (seen >= 0) & (seen < scores.shape[1])
    np.add.at(scores, (rows[ok], seen[ok]), -1e9)
    return scores


def assert_topk_equal_up_to_ties(got_vals, got_ids, want_vals, want_ids,
                                 scores, rtol=1e-5, atol=1e-5):
    got_vals, got_ids = np.asarray(got_vals), np.asarray(got_ids)
    want_vals, want_ids = np.asarray(want_vals), np.asarray(want_ids)
    np.testing.assert_allclose(got_vals, want_vals, rtol=rtol, atol=atol)
    assert_ids_equal_up_to_ties(got_ids, want_vals, want_ids, scores,
                                rtol, atol)


def assert_ids_equal_up_to_ties(got_ids, want_vals, want_ids, scores,
                                rtol=1e-5, atol=1e-5):
    got_ids = np.asarray(got_ids)
    want_vals = np.asarray(want_vals, np.float64)
    assert got_ids.shape == want_vals.shape
    for r in range(got_ids.shape[0]):
        assert len(set(got_ids[r].tolist())) == got_ids.shape[1], r
        mine = scores[r, got_ids[r]]
        tol = atol + rtol * np.abs(want_vals[r])
        bad = np.abs(mine - want_vals[r]) > tol
        assert not bad.any(), (
            f"row {r}: ids {got_ids[r][bad]} (score {mine[bad]}) where arec "
            f"has {np.asarray(want_ids)[r][bad]} (score {want_vals[r][bad]})")
