"""The share of the window's served calls answered by CUDA graph replays,
in %: the program's counter `serve.graph_replays` (arec_torch.obs: one
for each call of `serve.Recommender` that its captured steps answered)
over the window's calls. None where the counter is missing (a
program without the graph path, or a run off the card)."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its counters
        return None
    replays = obs.snapshot()["counts"].get("serve.graph_replays")
    calls = run.counts.get("calls")
    if not calls or replays is None:
        return None
    return 100.0 * replays / calls
