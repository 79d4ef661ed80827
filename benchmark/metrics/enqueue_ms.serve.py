"""Host ms a served call spends issuing its device work: the program's
spans `serve.query` (the query encode) and `serve.topk` (the seen-masked
top-k) of arec_torch.obs, their host time, over the window's calls."""


def read(run):
    try:
        from arec_torch import obs
    except ImportError:            # a program without its spans
        return None
    spans = obs.snapshot()["spans"]
    calls = run.counts.get("calls")
    if not calls or "serve.query" not in spans or "serve.topk" not in spans:
        return None
    return 1e3 * (spans["serve.query"]["total_s"]
                  + spans["serve.topk"]["total_s"]) / calls
