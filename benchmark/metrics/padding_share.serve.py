"""The padded share of the served rows, in %: 100 × (1 − live rows ÷ rows
dispatched), from the program's counters `serve.rows_live` and
`serve.rows` (arec_torch.obs: every batch's live requests and its
serve_batch)."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its counters
        return None
    counts = obs.snapshot()["counts"]
    rows = counts.get("serve.rows")
    if not rows or "serve.rows_live" not in counts:
        return None
    return 100.0 * (1.0 - counts["serve.rows_live"] / rows)
