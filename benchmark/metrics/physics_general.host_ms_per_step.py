"""The host's time to issue one control step of the general engine: the
mean host-clock span around `VectorEnv.step`, outside the profiled
stretch.  Nothing for a planar model."""


def read(run):
    spans = run.host.get("bench.env")
    if run.planar is not None or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
