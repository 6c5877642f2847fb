"""fit.graph_step_share: the share of training steps replayed from a CUDA
graph, in percent: the program's counter ``fit.graph_steps`` over
``fit.steps`` (every optimizer step), as
``s3grl_tpu_torch.profiling.counters`` gives them at the end of the traced
run: over every ``fit_signnet`` call of the run (set-up's warm run, the
unprofiled run and the profiled ones). None where the program keeps no
``fit.graph_steps`` counter."""


def read(ctx):
    try:
        from s3grl_tpu_torch.profiling import counters
    except ImportError:
        return None
    c = counters()
    if "fit.graph_steps" not in c or not c.get("fit.steps"):
        return None
    return 100.0 * c["fit.graph_steps"] / c["fit.steps"]
