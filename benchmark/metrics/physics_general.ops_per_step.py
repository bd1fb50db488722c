"""Device operations launched under one `VectorEnv.step` span of the
general engine, from the trace.  Nothing for a planar model."""


def read(run):
    tr = run.trace
    if run.planar is not None or tr is None or not tr.count("bench.env"):
        return None
    return tr.op_count("bench.env") / tr.count("bench.env")
