"""The host's time to issue one training iteration: the mean host-clock
span around `_train_iter`, with no synchronize inside, over the traced
run's iterations outside the profiled stretch."""


def read(run):
    spans = run.host.get("bench.iter")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
