"""The DMC half of the port's host paths (ilswiss_tpu_torch/envs/host_dmc.py,
launchers/experiments.py's `_hbm_replay_capacity`, `_run_host_sac_ae` and
gen_expert's DMC branch, SACAE.acting_state, and the visual path on uint8
frames) against the JAX package's, the twin of tests/test_dmc.py.

The DMC envs render through EGL (`MUJOCO_GL=egl`); where no GL stack
renders, the env cases skip as tests/test_dmc.py's do.  Inputs come from
numpy seeds; the JAX states cross by utils/convert.py, and every draw of a
JAX run is rebuilt from its keys (the JAX warmup's from the global
`np.random` calls it made) and replayed to the port in the port's
documented order (`_Draws` fails on a draw out of that order).  Sizes:
cartpole-balance at 32 px, 2 envs, frames stacked by 3 (9 channels), crop
28, 2 convs of 8 filters, feature_dim 16, 32 x 1 nets, batch 8.  Pins:
  - the env (frames, rewards, dones, the stack's roll, reseeded resets),
    the ring's uint8 rows, the gathers of the augmentations on uint8
    frames and the capacity rule: exact;
  - float32 forwards (the encoder on a uint8 batch): rtol 1e-5, atol 1e-6;
  - the runner's epoch (progress.csv's metrics and evaluation) rtol 2e-4,
    atol 2e-5, its end state rtol 2e-4, atol 1e-4: the pins of
    tests/test_torch_visual.py's updates (float32 convs on both sides).
"""

import csv
import dataclasses
import os
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.algorithms.sac_ae import SACAE as JSACAE
from ilswiss_tpu.algorithms.sac_ae import SACAEConfig as JSACAEConfig
from ilswiss_tpu.data import augmentations as jaug
from ilswiss_tpu.data import demo as jdemo
from ilswiss_tpu.data.aug_replay import augmented_sample as jaugmented_sample
from ilswiss_tpu.data.replay import replay_add as jreplay_add
from ilswiss_tpu.data.replay import replay_init as jreplay_init
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.models.encoders import PixelEncoder as JPixelEncoder
from ilswiss_tpu.runtime import host_loop as jhl
from ilswiss_tpu_torch.algorithms.sac_ae import SACAE, SACAEConfig
from ilswiss_tpu_torch.data import augmentations as aug
from ilswiss_tpu_torch.data.aug_replay import augmented_sample
from ilswiss_tpu_torch.data.replay import replay_add, replay_init
from ilswiss_tpu_torch.envs.vector import Transition
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.launchers.variant import build_variants
from ilswiss_tpu_torch.models.encoders import PixelEncoder
from ilswiss_tpu_torch.runtime import host_loop as phl
from ilswiss_tpu_torch.runtime.checkpoint import restore_subtree
from ilswiss_tpu_torch.runtime.loop import Noise
from ilswiss_tpu_torch.testing import PixelEnvAsHost
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)
os.environ.setdefault("MUJOCO_GL", "egl")

ROOT = Path(__file__).resolve().parents[1]
EXACT = dict(rtol=0, atol=0)
FWD = dict(rtol=1e-5, atol=1e-6)
METRIC = dict(rtol=2e-4, atol=2e-5)
PIN = dict(rtol=2e-4, atol=1e-4)
IMG, CROP, NE, B, FEAT, NF, NL, NET = 32, 28, 2, 8, 16, 8, 2, 32
T = torch.as_tensor
DMC_SPECS = sorted(p for d in ("sac_ae", "sac_rad", "sac_curl")
                   for p in (ROOT / "exp_specs" / d).glob("*_dmc_*.yaml"))


class _Draws:
    """The port's `Noise` methods, answering each call with the next of
    the JAX draws; a call out of the JAX order fails."""

    def __init__(self, seq):
        self.seq = list(seq)

    def _pop(self, kind):
        assert self.seq, f"no draw left for {kind}"
        got, value = self.seq.pop(0)
        assert got == kind, f"drew {kind} where the JAX order has {got}"
        if isinstance(value, tuple):
            return tuple(T(np.array(v)) for v in value)
        return T(np.array(value))

    def state_dict(self):
        return {}

    def __getattr__(self, kind):
        if kind not in vars(Noise):
            raise AttributeError(kind)
        return lambda *args: self._pop(kind)


def _close(got, want, pin, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got), set(want))
        for k in want:
            _close(got[k], want[k], pin, f"{path}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, pin, f"{path}/{i}")
    elif isinstance(want, int):
        assert got == want, path
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64),
                                   err_msg=path, **pin)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- the JAX draws -----------------------------------------------------------
@partial(jax.jit, static_argnums=(1, 2))
def _offsets(key, b, high):
    def one(k):
        kx, ky = jax.random.split(k)
        return jnp.stack([jax.random.randint(kx, (), 0, high + 1),
                          jax.random.randint(ky, (), 0, high + 1)])
    return jax.vmap(one)(jax.random.split(key, b))


@partial(jax.jit, static_argnums=(1, 2, 3))
def _boxes(key, b, h, w, min_cut=10, max_cut=30):
    def one(k):
        ks, kx, ky = jax.random.split(k, 3)
        return jnp.stack([jax.random.randint(ks, (), min_cut, max_cut),
                          jax.random.randint(kx, (), 0, w - max_cut),
                          jax.random.randint(ky, (), 0, h - max_cut)])
    return jax.vmap(one)(jax.random.split(key, b))


def _sample_draws(key, batch_size, out_size, cpc, imgs_shape):
    """The draws of JAX `augmented_sample(state, key, ...)` with the one
    augmentation "crop"."""
    k_sample, k_obs, k_next, k_anchor, k_pos = jax.random.split(key, 5)
    seq = [("replay", np.asarray(jax.random.uniform(k_sample,
                                                    (batch_size,))))]
    for k in (k_obs, k_next) + ((k_anchor, k_pos) if cpc else ()):
        _, k = jax.random.split(k)
        seq.append(("augment_index", np.asarray(
            _offsets(k, batch_size, imgs_shape[1] - out_size))))
    return seq


def _train_draws(key, batch_size, action_size):
    k_next, k_new = jax.random.split(key)
    return ("train", (np.asarray(jax.random.normal(k_next, (batch_size,
                                                             action_size))),
                      np.asarray(jax.random.normal(k_new, (batch_size,
                                                            action_size)))))


# --- 1. the env ---------------------------------------------------------------
def _dmc_pair(**kw):
    """The JAX and the port's DMCVectorEnv on the same arguments; skips
    where dm_control is missing or no GL stack renders."""
    pytest.importorskip("dm_control")
    from ilswiss_tpu.envs.host_dmc import DMCVectorEnv as JDMC
    from ilswiss_tpu_torch.envs.host_dmc import DMCVectorEnv

    envs = []
    try:
        for cls in (JDMC, DMCVectorEnv):
            envs.append(cls(**kw))
            envs[-1].reset(seed=0)
    except Exception as e:  # no GL stack on this machine
        for env in envs:
            env.close()
        pytest.skip(f"DMC rendering unavailable: {e}")
    return envs


def test_dmc_vector_env_matches_jax():
    """cartpole-balance at 32 px, 2 envs, 3 frames stacked, a 4-step time
    limit: the reset, 7 steps with actions beyond [-1, 1] (the rescale
    clips), autoresets, the stack's roll and reseeded resets, bit for bit
    (tests/test_dmc.py's contract: uint8 [H, W, 9], newest frame last,
    terminal never set, rewards in [0, 1])."""
    jenv, env = _dmc_pair(num_envs=NE, seed=3, domain_name="cartpole",
                          task_name="balance", height=IMG, width=IMG,
                          frame_stack=3, max_episode_steps=4)
    try:
        assert env.observation_size == jenv.observation_size == (IMG, IMG, 9)
        assert env.obs_dtype == np.uint8
        assert (env.action_size, env.max_episode_steps, env.name) == (
            jenv.action_size, jenv.max_episode_steps, jenv.name)
        first = env.reset(seed=1)
        np.testing.assert_array_equal(first, jenv.reset(seed=1))
        assert first.dtype == np.uint8 and first.shape == (NE, IMG, IMG, 9)
        # a fresh reset stacks one frame three times
        np.testing.assert_array_equal(first[..., :3], first[..., 6:])
        rng = np.random.RandomState(0)
        dones = []
        for t in range(7):
            a = rng.uniform(-1.5, 1.5, (NE, env.action_size))
            np.testing.assert_array_equal(env._scale(a.astype(np.float32)),
                                          jenv._scale(a.astype(np.float32)))
            got, want = env.step(a), jenv.step(a)
            for i, (g, w) in enumerate(zip(got, want)):
                assert g.dtype == w.dtype, i
                np.testing.assert_array_equal(g, w, err_msg=str(i))
            prev, true_next, reward, terminal, done, after = got
            assert not terminal.any()
            assert ((0.0 <= reward) & (reward <= 1.0)).all()
            # the stack rolls: the two older frames move up by one
            np.testing.assert_array_equal(true_next[..., :6], prev[..., 3:])
            dones.append(done)
        assert [bool(d.all()) for d in dones] == [False] * 3 + [True] + \
            [False] * 3
        again = env.reset(seed=5)
        np.testing.assert_array_equal(again, jenv.reset(seed=5))
        assert not np.array_equal(again, first)
        np.testing.assert_array_equal(env.reset(seed=1), first)
    finally:
        env.close()
        jenv.close()


# --- 2. uint8 frames through the visual path ----------------------------------
def _u8(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


@pytest.mark.parametrize("name", ["crop", "center_crop", "translate",
                                  "cutout", "grayscale"])
def test_uint8_augmentations_match_jax(name):
    """Each augmentation of the DMC ring's uint8 frames (4 stacks of 3
    frames, 48 px) against the JAX one from the same draws: dtype and
    values exactly (the grayscale's channel mean truncates to uint8 on
    both sides)."""
    imgs = _u8((4, 48, 48, 9))
    key = jax.random.PRNGKey(0)
    ji = jnp.asarray(imgs)
    if name == "crop":
        want = jaug.random_crop(key, ji, 40)
        got = aug.random_crop(T(imgs), 40, T(_offsets(key, 4, 8)))
    elif name == "center_crop":
        want, got = jaug.center_crop(ji, 40), aug.center_crop(T(imgs), 40)
    elif name == "translate":
        want = jaug.random_translate(key, ji, 56)
        got = aug.random_translate(T(imgs), 56, T(_offsets(key, 4, 8)))
    elif name == "cutout":
        want = jaug.random_cutout(key, ji)
        got = aug.random_cutout(T(imgs), T(_boxes(key, 4, 48, 48)))
    else:
        want = jaug.grayscale(key, ji, p=0.5)
        u = np.asarray(jax.random.uniform(key, (4, 1, 1, 1))).reshape(4)
        got = aug.grayscale(T(imgs), T(u), p=0.5)
        assert (u < 0.5).any() and (u >= 0.5).any()
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_fault_color_jitter_normalizes_uint8_frames():
    """The JAX color jitter takes uint8 frames' 0..255 values for [0, 1]
    ones: its value channel clips to 1 and its hue differences wrap in
    uint8, so the jittered frames come out near white whatever went in
    (ROADMAP.md section 3).  The port jitters x / 255 and rounds back to
    uint8: its output is the float jitter of the normalized frames, and
    the JAX float jitter of them agrees with it."""
    imgs = _u8((4, 16, 16, 9), 1)
    key = jax.random.PRNGKey(3)
    korder, kp, kb, kc, ks, kh = jax.random.split(key, 6)
    u = np.zeros((6, 4), np.float32)
    u[0, 0] = jax.random.uniform(korder, ())
    for row, k in enumerate((kp, kb, kc, ks, kh), start=1):
        u[row] = jax.random.uniform(k, (4,))
    got = aug.color_jitter(T(imgs), T(u))
    assert got.dtype == torch.uint8
    unit = imgs.astype(np.float32) / 255.0
    want = np.asarray(jax.jit(jaug.color_jitter)(key, jnp.asarray(unit)))
    np.testing.assert_allclose(got.numpy() / 255.0, want, rtol=0,
                               atol=0.5 / 255 + 1e-5)
    # the JAX function on the uint8 frames themselves
    raw = np.asarray(jax.jit(jaug.color_jitter)(key, jnp.asarray(imgs)))
    assert raw.dtype == np.float32 and raw.max() <= 1.0
    assert np.abs(raw - want).mean() > 0.2


def test_uint8_ring_sample_and_encoder_match_jax():
    """A uint8 ring (the DMC runner's), `augmented_sample` with a crop and
    CURL's views from the JAX draws (uint8 out, exactly), and the encoder
    on that uint8 batch (divided by 255 by the batch's max, float32
    convs) against the JAX encoder with the same parameters."""
    shape, out = (IMG, IMG, 9), CROP
    ring = replay_init(32, shape, 1, NE, "cpu", obs_dtype=torch.uint8)
    jring = jreplay_init(32, shape, 1, write_batch=NE, obs_dtype=jnp.uint8)
    add = jax.jit(jreplay_add)
    for i in range(5):
        tr = dict(obs=_u8((NE,) + shape, i),
                  action=np.zeros((NE, 1), np.float32),
                  reward=np.arange(NE, dtype=np.float32),
                  next_obs=_u8((NE,) + shape, 10 + i),
                  terminal=np.zeros(NE, bool), done=np.zeros(NE, bool))
        jring = add(jring, JTransition(
            **{k: jnp.asarray(v) for k, v in tr.items()}))
        ring = replay_add(ring, Transition(**{k: T(v) for k, v in
                                              tr.items()}))
    assert ring.data["obs"].dtype == torch.uint8
    key = jax.random.PRNGKey(4)
    want = jax.jit(partial(jaugmented_sample, batch_size=B, augs=("crop",),
                           out_size=out, cpc=True))(jring, key)
    noise = _Draws(_sample_draws(key, B, out, True, (B,) + shape))
    got = augmented_sample(ring, noise, B, augs=("crop",), out_size=out,
                           cpc=True)
    assert not noise.seq
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.asarray(want[k])).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    jenc = JPixelEncoder(feature_dim=FEAT, num_layers=NL, num_filters=NF,
                         compute_dtype=jnp.float32)
    obs = np.asarray(want["obs"])
    assert obs.dtype == np.uint8 and obs.max() > 1
    variables = jenc.init(jax.random.PRNGKey(1), jnp.asarray(obs))
    enc = PixelEncoder(out, 9, torch.Generator().manual_seed(0),
                       feature_dim=FEAT, num_layers=NL, num_filters=NF,
                       compute_dtype=torch.float32)
    convert.encoder_from_jax(enc, _np(variables))
    _close(enc(T(obs)).detach().numpy(),
           np.asarray(jenc.apply(variables, jnp.asarray(obs))), FWD)


def _u8_batch(seed, size=CROP):
    rng = np.random.RandomState(seed)
    img = lambda: rng.randint(0, 256, (B, size, size, 9)).astype(  # noqa
        np.uint8)
    return {"obs": img(), "action": rng.uniform(-1, 1, (B, 1)).astype(
                np.float32),
            "reward": rng.randn(B).astype(np.float32),
            "terminal": np.zeros(B, np.float32), "next_obs": img(),
            "observations_anchor": img(), "observations_pos": img()}


def test_uint8_autoencoder_step_matches_jax():
    """The autoencoder step (`_train_encdec`: the reconstruction of the
    frames divided by 255 and centered, the latent penalty, one Adam over
    encoder and decoder) twice on uint8 batches from the JAX trainer's
    initial state: metrics at rtol 2e-4, atol 2e-5, the state at rtol
    2e-4, atol 1e-4 (float32 convs)."""
    kw = dict(image_size=CROP, frame_channels=9, feature_dim=FEAT,
              num_conv_layers=NL, num_filters=NF, conv_dtype="float32",
              cpc_update_freq=1)
    jalgo = JSACAE(1, JSACAEConfig(**kw), net_size=NET, num_hidden_layers=1)
    algo = SACAE(1, SACAEConfig(**kw), net_size=NET, num_hidden_layers=1,
                 device="cpu")
    js = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    state = convert.sac_ae_state_from_jax(algo, _np(js))
    encdec = jax.jit(jalgo._train_encdec)
    for i in range(2):
        batch = _u8_batch(3 + i)
        js, jm = encdec(js, batch)
        m = algo._train_encdec(state, {k: T(v) for k, v in batch.items()})
        _close({k: float(v) for k, v in m.items()},
               {k: float(v) for k, v in jm.items()}, METRIC)
    _close(convert.sac_ae_state_to_numpy(state), _jax_sacae_numpy(_np(js)),
           PIN)


def test_acting_state_keeps_the_encoder_and_the_policy():
    """`SACAE.acting_state` (JAX sac_ae.py:162-172) and the loops' crop
    wrapper forwarding it: the host loop's acting copy holds the encoder
    and the policy only, and acts as the whole state does."""
    algo = SACAE(1, SACAEConfig(image_size=CROP, frame_channels=9,
                                feature_dim=FEAT, num_conv_layers=NL,
                                num_filters=NF, conv_dtype="float32"),
                 net_size=NET, num_hidden_layers=1, device="cpu")
    state = algo.init(0)
    view = partial(aug.center_crop, out_size=CROP)
    wrapped = pexp._CropActing(algo, view)
    assert wrapped.acting_state(state).encoder is state.encoder
    env = PixelEnvAsHost(NE, seed=0, height=IMG)
    loop = phl.HostOffPolicyLoop(env, wrapped, phl.HostLoopConfig(
        replay_capacity=16, batch_size=B))
    snap = loop.acting_snapshot(state)
    kept = {f.name for f in dataclasses.fields(snap)
            if getattr(snap, f.name) is not None}
    assert kept == {"encoder", "policy", "step"}
    assert snap.encoder.fc.weight is not state.encoder.fc.weight
    obs = T(env.reset(seed=0))
    assert torch.equal(wrapped.act(snap, obs, deterministic=True),
                       wrapped.act(state, obs, deterministic=True))
    runner = loop.init(0)
    assert runner.replay.data["obs"].dtype == torch.uint8


# --- 3. the ring's capacity rule ---------------------------------------------
class _Log:
    def __init__(self):
        self.lines = []

    def log(self, line):
        self.lines.append(line)


@pytest.mark.parametrize("requested,shape", [
    (20_000, (84, 84, 9)), (1_000_000, (84, 84, 9)), (100_000, (100, 100, 9)),
    (500, (32, 32, 9)), (30_000, (108, 108, 9))])
def test_hbm_replay_capacity_matches_jax(requested, shape):
    """On the CPU both take the JAX launcher's 16 GB fallback: the same
    capacity and the same log line.  On a card the port reads the free
    memory from `torch.cuda.mem_get_info`."""
    jlog, plog = _Log(), _Log()
    want = jexp._hbm_replay_capacity(requested, shape, jlog)
    got = pexp._hbm_replay_capacity(requested, shape, plog, "cpu")
    assert got == want and plog.lines == jlog.lines
    assert got <= requested and (got % 1000 == 0 or got == requested)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "mem_get_info",
                   lambda device=None: (8_000_000_000, 80_000_000_000))
        card = pexp._hbm_replay_capacity(requested, shape, plog, "cuda")
    per_row = 2 * int(np.prod(shape))
    assert card == min(requested, max(
        1000, int(8e9 * 0.35) // per_row // 1000 * 1000))
    assert "free HBM 8.0 GB" in plog.lines[-1]


# --- 4. the launcher's configuration of every DMC spec -----------------------
ACTIONS = {"cartpole": 1, "cheetah": 6, "ball_in_cup": 2, "finger": 2,
           "hopper": 4, "pendulum": 1, "reacher": 2, "walker": 6}


class _SizesOnly:
    """A DMC env that only gives its sizes (what the launcher reads before
    the loop's init)."""

    obs_dtype = np.uint8

    def __init__(self, num_envs, seed=0, domain_name="finger", height=84,
                 width=84, frame_stack=3, **_):
        self.num_envs, self.name = num_envs, f"dmc-{domain_name}"
        self.observation_size = (height, width, 3 * frame_stack)
        self.action_size = ACTIONS[domain_name]
        self.discrete = False

    def reset(self, seed=None):
        return np.zeros((self.num_envs,) + self.observation_size, np.uint8)

    def close(self):
        pass


def _spec(path, **constants):
    with open(path) as f:
        (v,) = build_variants(yaml.safe_load(f))
    v.update(print_to_console=False, **constants)
    return v


def _built(run, variant, log_dir, **kw):
    """The loop `run` builds from `variant`, stopped at its `init`."""
    import ilswiss_tpu.envs.host_dmc as jdmc
    import ilswiss_tpu_torch.envs.host_dmc as pdmc

    seen = {}

    class Stop(Exception):
        pass

    def init(self, *args, **kwargs):
        seen["loop"] = self
        raise Stop

    jinit = jhl.HostOffPolicyLoop.__init__

    def keep_sampler(self, env, algo, config, sample_fn=None):
        jinit(self, env, algo, config, sample_fn=sample_fn)
        self.sample_fn = sample_fn        # the JAX loop keeps no such field

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdmc, pdmc):
            mp.setattr(mod, "DMCVectorEnv", _SizesOnly)
        mp.setattr(jhl.HostOffPolicyLoop, "__init__", keep_sampler)
        mp.setattr(jhl.HostOffPolicyLoop, "init", init)
        mp.setattr(phl.HostOffPolicyLoop, "init", init)
        with pytest.raises(Stop):
            run(dict(variant, log_dir=str(log_dir)), **kw)
    return seen["loop"]


@pytest.mark.parametrize("spec", DMC_SPECS, ids=lambda p: p.stem)
def test_run_sac_ae_dmc_reads_the_specs_as_the_jax_launcher(tmp_path, spec):
    """The trainer, nets, segment rule, ring capacity, crop and sampler
    that the DMC branch builds from each of the 21 DMC specs, against the
    JAX launcher's; the encoder from `encoder_params`.
    sac_rad_dmc_reach_easy.yaml's num_epochs reads "7s20": both launchers
    raise ValueError on it, after building the loop."""
    v = _spec(spec)
    if not str(v["rl_alg_params"]["num_epochs"]).isdigit():
        for run, kw, name in ((pexp.run_sac_ae, {"device": "cpu"}, "p"),
                              (jexp.run_sac_ae, {}, "j")):
            with pytest.raises(ValueError, match="invalid literal"):
                _built(run, v, tmp_path / name, **kw)
        return
    p = _built(pexp.run_sac_ae, v, tmp_path / "port", device="cpu")
    j = _built(jexp.run_sac_ae, v, tmp_path / "jax")
    palgo = p.algo.algo
    jalgo = getattr(j.algo, "init", None)
    jalgo = getattr(jalgo, "__self__", j.algo)
    assert dataclasses.asdict(palgo.config) == \
        dataclasses.asdict(jalgo.config)
    assert palgo.hidden == (v.get("net_size", 1024),) * v.get(
        "num_hidden_layers", 2)
    pc, jc = dataclasses.asdict(p.config), dataclasses.asdict(j.config)
    assert pc == jc, (pc, jc)
    assert (p.sample_fn.keywords if hasattr(p.sample_fn, "keywords")
            else None) == (j.sample_fn.keywords if j.sample_fn else None)
    enc = v["encoder_params"]
    assert palgo.config.feature_dim == enc["encoder_feature_dim"]
    assert palgo.config.num_conv_layers == enc["num_layers"]


def test_dmc_branch_reads_encoder_params_where_the_device_branch_does_not(
        tmp_path):
    """The host branch reads the encoder from `encoder_params`, the
    top-level feature_dim / num_conv_layers / num_filters only where it
    has none; the device branch (pendulum_pixels) reads the top level
    alone (JAX experiments.py:1258-1266 against :1436-1438)."""
    top = dict(feature_dim=7, num_conv_layers=3, num_filters=5)
    v = _spec(DMC_SPECS[0], **top)
    v["encoder_params"] = {"encoder_feature_dim": 11, "num_layers": 2}
    for run, kw, name in ((pexp.run_sac_ae, {"device": "cpu"}, "p"),
                          (jexp.run_sac_ae, {}, "j")):
        loop = _built(run, v, tmp_path / name, **kw)
        algo = loop.algo.algo if name == "p" else getattr(
            getattr(loop.algo, "init", None), "__self__", loop.algo)
        assert (algo.config.feature_dim, algo.config.num_conv_layers,
                algo.config.num_filters) == (11, 2, 5)
    pix = _spec(ROOT / "exp_specs" / "sac_ae" / "sac_ae_pendulum_pixels.yaml",
                **top)
    pix["encoder_params"] = {"encoder_feature_dim": 11, "num_layers": 2}
    pix["env_specs"] = dict(pix["env_specs"], env_num=2,
                            env_kwargs={"image_size": 24})
    seen = {}

    class Stop(Exception):
        pass

    def init(self, *args, **kwargs):
        seen["algo"] = self.algo.algo
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pexp.OffPolicyLoop, "init", init)
        with pytest.raises(Stop):
            pexp.run_sac_ae(dict(pix, log_dir=str(tmp_path / "d")),
                            device="cpu")
    cfg = seen["algo"].config
    assert (cfg.feature_dim, cfg.num_conv_layers, cfg.num_filters) == (7, 3,
                                                                        5)


# --- 5. one epoch of the DMC runner against the JAX runner --------------------
def _cut_dmc(tmp_path, name, **rl):
    """sac_curl_dmc_finger_spin.yaml (CURL, crop) on cartpole-balance at
    32 px cut to 2 envs (crop 28 through `augmentation_params`), 2 convs of
    8, feature_dim 16, 32 x 1 nets, the spec's CURL steps (its autoencoder
    off: `test_uint8_autoencoder_step_matches_jax` holds that step); a 4-step
    warmup a env, one 8-step segment of 2 gradient steps at batch 8 (a 1 :
    4 ratio over `min_segment_steps` 8), one epoch, one evaluation
    episode."""
    v = _spec(ROOT / "exp_specs" / "sac_curl" /
              "sac_curl_dmc_finger_spin.yaml")
    v.update(net_size=NET, num_hidden_layers=1, log_dir=str(tmp_path / name))
    v["encoder_params"] = dict(v["encoder_params"], encoder_feature_dim=FEAT,
                               num_layers=NL, num_filters=NF)
    v["augmentation_params"] = dict(v["augmentation_params"],
                                    image_size=CROP)
    v["env_specs"] = dict(v["env_specs"], env_num=NE, env_kwargs=dict(
        v["env_specs"]["env_kwargs"], domain_name="cartpole",
        task_name="balance", height=IMG, width=IMG, frame_skip=1))
    v["rl_alg_params"] = dict(
        v["rl_alg_params"], num_epochs=1, num_steps_per_epoch=4 * NE,
        min_steps_before_training=4 * NE, num_steps_between_train_calls=4,
        num_train_steps_per_train_call=1, min_segment_steps=4 * NE,
        num_steps_per_eval=5, max_path_length=5, batch_size=B,
        replay_buffer_size=64, **rl)
    return v


def _short_dmc(cls, steps=5):
    """The DMC env class with a `steps`-step time limit."""
    return partial(cls, max_episode_steps=steps)


def test_run_sac_ae_dmc_epoch_matches_jax(tmp_path, monkeypatch):
    """One epoch of the DMC branch (`_cut_dmc`, 5-step episodes) against
    the JAX launcher's on the CPU: the port's runner starts from the JAX
    launcher's trainer state, and every draw of the JAX warmup (its
    global `np.random.uniform` calls), the segment's acting (the center
    crop of uint8 frames), the learner's 2 steps (the augmented sampler on
    the uint8 ring, CURL's views) is replayed in the port's order; the
    evaluation is deterministic.  progress.csv's values but the clocks,
    the uint8 ring and the end state agree; both write 'best' and a light
    'last'.  float32 convs on both sides."""
    pytest.importorskip("dm_control")
    import ilswiss_tpu.algorithms.sac_ae as jsac_ae
    import ilswiss_tpu.envs.host_dmc as jdmc
    import ilswiss_tpu_torch.algorithms.sac_ae as psac_ae
    import ilswiss_tpu_torch.envs.host_dmc as pdmc

    _dmc_pair(num_envs=1, height=IMG, width=IMG, domain_name="cartpole",
              task_name="balance")[0].close()   # skips without GL
    for mod, cfg in ((jsac_ae, JSACAEConfig), (psac_ae, SACAEConfig)):
        monkeypatch.setattr(mod, "SACAEConfig",
                            partial(cfg, conv_dtype="float32"))
    for mod in (jdmc, pdmc):
        monkeypatch.setattr(mod, "DMCVectorEnv",
                            _short_dmc(mod.DMCVectorEnv))
    v = _cut_dmc(tmp_path, "jax")
    seed = v["seed"]
    started, warm = [], []
    jinit, uniform = jhl.HostOffPolicyLoop.init, np.random.uniform

    def keep(self, seed=0):
        out = jinit(self, seed)
        started.append(jax.tree.map(np.array, out))   # before donation
        return out

    def record(low=0.0, high=1.0, size=None):
        out = uniform(low, high, size)
        if (low, high, size) == (-1.0, 1.0, (NE, 1)):
            warm.append(out.astype(np.float32))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhl.HostOffPolicyLoop, "init", keep)
        mp.setattr(np.random, "uniform", record)
        jr = jexp.run_sac_ae(dict(v))
    jr = _np(jr)
    start = started[0]
    assert len(warm) == 4

    # the JAX draws: the segment's acting keys fold in the env steps taken
    # before it; the learner's call splits the runner's key
    key = jax.random.fold_in(jnp.asarray(start.rng), 4 * NE)
    acting = []
    for _ in range(4):
        key, k = jax.random.split(key)
        acting.append(("act", np.asarray(jax.random.normal(k, (NE, 1)))))
    _, k = jax.random.split(jnp.asarray(start.rng))
    learner = []
    for kk in jax.random.split(k, 2):
        k_s, k_t = jax.random.split(kk)
        learner += _sample_draws(k_s, B, CROP, True, (B, IMG, IMG, 9))
        learner.append(_train_draws(k_t, B, 1))
    collectors = [_Draws([("warmup_action", w) for w in warm]),
                  _Draws(acting)]

    pinit = phl.HostOffPolicyLoop.init

    def port_init(self, seed=0, noise=None):
        runner = pinit(self, seed, noise=_Draws(learner))
        runner.algo_state = convert.sac_ae_state_from_jax(
            self.algo.algo, start.algo_state)
        return runner

    monkeypatch.setattr(phl.HostOffPolicyLoop, "init", port_init)
    monkeypatch.setattr(phl, "collector_noise",
                        lambda seed, steps: collectors.pop(0))
    runner = pexp.run_sac_ae(_cut_dmc(tmp_path, "port"), device="cpu")
    assert not collectors and not runner.noise.seq
    rows = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "progress.csv") as f:
            (rows[name],) = list(csv.DictReader(f))
    keys = set(rows["jax"]) - {"TrainTime", "WallTime", "Epoch",
                               "EnvStepsPerSec", "SnapshotTime"}
    assert set(rows["port"]) == set(rows["jax"])
    _close({k: float(rows["port"][k]) for k in keys},
           {k: float(rows["jax"][k]) for k in keys}, METRIC)
    assert float(rows["port"]["TotalEnvSteps"]) == 8 * NE
    assert runner.algo_state.step == 2
    ring = convert.replay_to_numpy(runner.replay)
    for k in ("obs", "next_obs"):
        assert ring["data"][k].dtype == np.uint8
        np.testing.assert_array_equal(ring["data"][k], jr.replay.data[k])
    _close(convert.sac_ae_state_to_numpy(runner.algo_state),
           _jax_sacae_numpy(jr.algo_state), PIN)
    for name in ("jax", "port"):
        ckpts = tmp_path / name / "checkpoints"
        assert {"best", "last"} <= set(os.listdir(ckpts))
    meta = (tmp_path / "port" / "checkpoints" / "meta.json").read_text()
    assert '"light": true' in meta


def _jax_sacae_numpy(jstate):
    out = {f.name: getattr(jstate, f.name)
           for f in dataclasses.fields(jstate)}
    for k in ("qf_opt", "policy_opt", "alpha_opt", "encdec_opt", "cpc_opt"):
        a = out[k][0]
        out[k] = {"count": int(a.count), "mu": a.mu, "nu": a.nu}
    out["step"] = int(jstate.step)
    return out


# --- 6. the runner's schedule, snapshots and resume; gen_expert ---------------
@pytest.fixture(scope="module")
def standin_runs(tmp_path_factory):
    """The cut spec through the port's DMC branch over the uint8 stand-in
    (`PixelEnvAsHost`, 5-step episodes): 2 epochs straight, then from its
    'last' a light resume for a third."""
    import ilswiss_tpu_torch.envs.host_dmc as pdmc

    root = tmp_path_factory.mktemp("dmc_standin")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pdmc, "DMCVectorEnv", _short_dmc(PixelEnvAsHost))
        v = _cut_dmc(root, "a")
        v["rl_alg_params"]["num_epochs"] = 2
        first = pexp.run_sac_ae(v, device="cpu")
        v = _cut_dmc(root, "a")
        v["rl_alg_params"]["num_epochs"] = 3
        v["load_params"] = str(root / "a")
        resumed = pexp.run_sac_ae(v, device="cpu")
    return root, first, resumed


def _rows(log_dir):
    with open(Path(log_dir) / "progress.csv") as f:
        return [{k: float(x) for k, x in r.items()}
                for r in csv.DictReader(f)]


def test_run_sac_ae_dmc_light_resume_and_snapshots(standin_runs):
    """Light snapshots by default ('last' and 'best' params only, 'last'
    every min(4, freq_saving) epochs and at the end); a light resume
    reruns the warmup and logs TotalEnvSteps by the decided convention
    (start_epoch * num_steps_per_epoch plus the runner's count since the
    new warmup), every value finite."""
    root, first, resumed = standin_runs
    rows = _rows(root / "a")
    assert [r["Epoch"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(x) for r in rows for x in r.values())
    assert [r["TotalEnvSteps"] for r in rows] == [16, 24, 2 * 8 + 16]
    assert first.total_env_steps == 24 and resumed.total_env_steps == 16
    assert first.algo_state.step == 4 and resumed.algo_state.step == 6
    assert sorted(os.listdir(root / "a" / "checkpoints")) == [
        "best", "last", "meta.json"]
    assert "light-resumed algo state" in (root / "a" / "debug.log"
                                          ).read_text()


def test_run_sac_ae_dmc_prewarm_and_wall_budget(tmp_path, monkeypatch):
    """`prewarm_only` trains one segment and exits without an epoch row;
    `max_wall_minutes` past at an epoch boundary flushes 'last' for the
    epoch before and exits."""
    import ilswiss_tpu_torch.envs.host_dmc as pdmc

    monkeypatch.setattr(pdmc, "DMCVectorEnv", _short_dmc(PixelEnvAsHost))
    r = pexp.run_sac_ae(_cut_dmc(tmp_path, "pre", prewarm_only=True),
                        device="cpu")
    assert r.algo_state.step == 2 and r.total_env_steps == 16
    assert "prewarm: one segment" in (tmp_path / "pre" / "debug.log"
                                      ).read_text()
    assert not (tmp_path / "pre" / "progress.csv").exists()
    # the launcher's clock: the start, epoch 0's check, its train and
    # snapshot clocks, then past the budget at epoch 1's check
    calls = []

    def clock():
        calls.append(1)
        return 0.0 if len(calls) <= 6 else 1e4

    monkeypatch.setattr(pexp, "time", types.SimpleNamespace(time=clock))
    v = _cut_dmc(tmp_path, "wall", max_wall_minutes=1)
    v["rl_alg_params"]["num_epochs"] = 5
    pexp.run_sac_ae(v, device="cpu")
    assert len(_rows(tmp_path / "wall")) == 1
    assert "wall budget 1 min reached at epoch 1" in (
        tmp_path / "wall" / "debug.log").read_text()
    assert (tmp_path / "wall" / "checkpoints" / "last").is_dir()


def test_gen_expert_dmc_branch_writes_the_jax_format(standin_runs, tmp_path,
                                                     monkeypatch):
    """gen_expert's DMC branch from the DMC runner's 'best' snapshot,
    acting through the center crop (`augmentation_params`) over the env
    it built (`_collect_host_transitions(env=...)`, closed on exit): the
    file loads in the JAX package and equals, key by key and dtype by
    dtype, what the JAX package writes for the same transitions; its
    listing entry counts them."""
    import ilswiss_tpu_torch.envs.host_dmc as pdmc

    root, first, _ = standin_runs
    closed = []

    class Env(PixelEnvAsHost):
        def close(self):
            closed.append(True)

    monkeypatch.setattr(pdmc, "DMCVectorEnv", _short_dmc(Env))
    v = _spec(ROOT / "exp_specs" / "gen_expert" / "finger_spin.yaml")
    out = tmp_path / "demos.npz"
    v.update(expert_path=str(root / "a" / "checkpoints" / "best"),
             net_size=NET, num_hidden_layers=1, num_rollouts=2,
             max_path_length=5, save_path=str(out),
             demos_listing=str(tmp_path / "list.yaml"),
             log_dir=str(tmp_path / "g"),
             augmentation_params={"data_augs": "crop", "image_size": CROP})
    v["encoder_params"] = dict(v["encoder_params"], encoder_feature_dim=FEAT,
                               num_layers=NL, num_filters=NF)
    v["env_specs"] = dict(v["env_specs"], env_num=NE, env_kwargs=dict(
        v["env_specs"]["env_kwargs"], height=IMG, width=IMG))
    assert pexp.run_gen_expert(v, device="cpu") == str(out)
    assert closed == [True]
    got = dict(np.load(out))
    assert got["obs"].shape == (10, IMG, IMG, 9)
    assert got["obs"].dtype == np.float32 and got["obs"].max() > 1
    jstate = jdemo.load_demos_npz(str(out))
    assert int(jstate.size) == 10
    ref = tmp_path / "jax.npz"
    jdemo.save_demos_npz(str(ref), jdemo.demos_to_replay_state(
        got["obs"], got["action"], got["reward"], got["next_obs"],
        got["terminal"], got["ep_id"]))
    want = dict(np.load(ref))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    listing = yaml.safe_load((tmp_path / "list.yaml").read_text())
    assert listing[v["expert_name"]] == {
        "file_path": str(out), "env": "dmc", "num_transitions": 10}
    # the expert acted: the snapshot's deterministic actions on the first
    # frames, through the center crop
    algo = SACAE(1, SACAEConfig(image_size=CROP, frame_channels=9,
                                feature_dim=FEAT, num_conv_layers=NL,
                                num_filters=NF), net_size=NET,
                 num_hidden_layers=1, device="cpu")
    state = restore_subtree(v["expert_path"], algo.init(0))
    want_a = algo.act(state, aug.center_crop(
        T(got["obs"][:NE]), CROP), deterministic=True)
    np.testing.assert_allclose(got["action"][:NE], want_a.numpy(),
                               rtol=1e-5, atol=1e-6)
