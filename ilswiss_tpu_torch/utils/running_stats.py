"""Running observation moments (counterpart:
ilswiss_tpu/utils/running_stats.py; `RunningMeanStd`,
`running_mean_std_init`, `running_mean_std_update`, `normalize`,
`unnormalize`).

The reference vec-env's obs_rms (rlkit/envs/vecenvs.py:102-107,299-327):
the count starts at eps = 1e-4, a batch is merged by Chan's parallel
rule, and the variance is the population variance (`jnp.var`, ddof 0).
`running_mean_std_update` returns new tensors and leaves its argument
alone.  With a `group` (the JAX `axis_name`; parallel/mesh.py) every rank
merges the same global batch moments: the mean across ranks of `var +
mean**2` and of `mean` (one all-reduce), the variance recentred on the
global mean, and the count times the world size (every rank's batch is
as large).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ilswiss_tpu_torch.parallel.distributed import all_reduce_mean


@dataclass
class RunningMeanStd:
    mean: torch.Tensor       # [*shape]
    var: torch.Tensor        # [*shape]
    count: torch.Tensor      # 0-d


def running_mean_std_init(shape, device, eps: float = 1e-4
                          ) -> RunningMeanStd:
    kw = dict(dtype=torch.float32, device=device)
    return RunningMeanStd(mean=torch.zeros(shape, **kw),
                          var=torch.ones(shape, **kw),
                          count=torch.tensor(eps, **kw))


def running_mean_std_update(rms: RunningMeanStd, batch: torch.Tensor,
                            group=None) -> RunningMeanStd:
    """The moments with the rows of `batch` [B, *shape] merged in; with a
    `group`, the rows of every rank's batch."""
    batch = batch.reshape((-1,) + tuple(rms.mean.shape))
    batch_mean = torch.mean(batch, dim=0)
    batch_var = torch.var(batch, dim=0, correction=0)
    rows = batch.shape[0]
    if group is not None:
        global_sq, batch_mean = all_reduce_mean(
            [batch_var + batch_mean ** 2, batch_mean], group)
        batch_var = global_sq - batch_mean ** 2
        rows *= group.world_size
    batch_count = torch.tensor(float(rows), dtype=rms.count.dtype,
                               device=rms.count.device)
    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * (batch_count / tot)
    m_a = rms.var * rms.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * (rms.count * batch_count / tot)
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


def normalize(rms: RunningMeanStd, x: torch.Tensor,
              clip: float | None = 10.0, eps: float = 1e-8) -> torch.Tensor:
    y = (x - rms.mean) / torch.sqrt(rms.var + eps)
    if clip is not None:
        y = torch.clamp(y, -clip, clip)
    return y


def unnormalize(rms: RunningMeanStd, y: torch.Tensor, eps: float = 1e-8
                ) -> torch.Tensor:
    """The inverse of `normalize` for values it did not clip."""
    return y * torch.sqrt(rms.var + eps) + rms.mean
