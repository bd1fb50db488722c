"""The visual path of the port (envs/classic/pendulum_pixels.py,
envs/wrappers.py::FrameStackEnv, data/replay.py's image rings,
data/augmentations.py, data/aug_replay.py, models/encoders.py,
algorithms/sac_ae.py, the loop's `sample_fn`, models/discriminators.py::
CNNDisc, AdvIRL's cnn branch and launchers/experiments.py::run_sac_ae)
against the JAX package's, the twin of tests/test_visual.py, of
tests/test_exploration_wrappers.py::test_frame_stack_env and of
tests/test_il.py::test_visual_gail_cnn_disc_epoch.

Inputs come from a numpy seed; the JAX states are carried across by
utils/convert.py, and every draw of a JAX function is rebuilt from its
keys and replayed to the port in the port's documented order (`_Draws`
fails on a draw out of that order).  Sizes: 24 px frames (crop 20), 2
convs of 8 filters, feature_dim 16, 32 x 1 nets, batch 8.  Pins:
  - dynamics, rewards and the frame stack's moves: rtol = atol = 1e-6 (a
    few float32 operations in the same order); rendered frames rtol =
    atol = 1e-5 (a pixel is 1 - d / 0.12, which scales the rounding of
    the distance d, a sin, a cos and a sqrt, by 8.3);
  - augmentations: exact (gathers), the grayscale's channel mean atol
    1e-7, the color jitter atol 1e-5;
  - float32 forwards (encoder, decoder, CNNDisc): rtol 1e-5, atol 1e-6;
    their gradients rtol 1e-4, atol 1e-6;
  - updates (`_train_ac`, `_train_encdec`, `_train_cpc`, `train_step`,
    a launcher epoch, the cnn discriminator step): metrics (and the
    epoch's evaluation) rtol 2e-4, atol 2e-5,
    the port's pin for a float32 learner (tests/test_torch_sac.py);
    parameters and Adam moments rtol 2e-4, atol 1e-4.  The atol is 10%
    of one Adam step (lr 1e-3): an element whose gradient is at rounding
    level moves by up to lr * g / (|g| + eps) a step, in a direction the
    rounding picks, and the shared encoder takes three Adams a step (the
    same effect as the BatchNorm biases of tests/test_torch_adv_irl.py);
  - bf16 convs (the spec's default): encoder features atol 3e-2 against
    the JAX bf16 encoder and against the float32 one (bf16 has an 8-bit
    mantissa; the LayerNorm rescales the conv features to unit scale).
"""

import csv
import dataclasses
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ilswiss_tpu.algorithms.adv_irl import AdvIRL as JAdvIRL
from ilswiss_tpu.algorithms.adv_irl import AdvIRLConfig as JAdvIRLConfig
from ilswiss_tpu.algorithms.sac import SAC as JSAC
from ilswiss_tpu.algorithms.sac import SACConfig as JSACConfig
from ilswiss_tpu.algorithms.sac_ae import SACAE as JSACAE
from ilswiss_tpu.algorithms.sac_ae import SACAEConfig as JSACAEConfig
from ilswiss_tpu.data import augmentations as jaug
from ilswiss_tpu.data.aug_replay import augmented_sample as jaugmented_sample
from ilswiss_tpu.data.replay import replay_add as jreplay_add
from ilswiss_tpu.data.replay import replay_init as jreplay_init
from ilswiss_tpu.envs import make as jmake
from ilswiss_tpu.envs import make_vec as jmake_vec
from ilswiss_tpu.envs.vector import Transition as JTransition
from ilswiss_tpu.envs.wrappers import FrameStackEnv as JFrameStackEnv
from ilswiss_tpu.launchers import experiments as jexp
from ilswiss_tpu.models.discriminators import CNNDisc as JCNNDisc
from ilswiss_tpu.models.encoders import PixelDecoder as JPixelDecoder
from ilswiss_tpu.models.encoders import PixelEncoder as JPixelEncoder
from ilswiss_tpu.runtime.loop import OffPolicyConfig as JLoopConfig
from ilswiss_tpu.runtime.loop import OffPolicyLoop as JLoop
from ilswiss_tpu_torch.algorithms.adv_irl import AdvIRL, AdvIRLConfig
from ilswiss_tpu_torch.algorithms.sac import SAC, SACConfig
from ilswiss_tpu_torch.algorithms.sac_ae import SACAE, SACAEConfig
from ilswiss_tpu_torch.data import augmentations as aug
from ilswiss_tpu_torch.data.aug_replay import augmented_sample
from ilswiss_tpu_torch.data.replay import replay_add, replay_init
from ilswiss_tpu_torch.envs import make, make_vec
from ilswiss_tpu_torch.envs.vector import Transition
from ilswiss_tpu_torch.envs.wrappers import FrameStackEnv
from ilswiss_tpu_torch.launchers import experiments as pexp
from ilswiss_tpu_torch.models.discriminators import CNNDisc
from ilswiss_tpu_torch.models.encoders import (
    PixelDecoder, PixelEncoder, conv_out_dim,
)
from ilswiss_tpu_torch.runtime.collector import collect_transitions
from ilswiss_tpu_torch.runtime.loop import (
    Noise, OffPolicyConfig, OffPolicyLoop, RunnerState,
)
from ilswiss_tpu_torch.utils import convert

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(rtol=1e-6, atol=1e-6)
FRAME = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=0, atol=0)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
METRIC = dict(rtol=2e-4, atol=2e-5)
PIN = dict(rtol=2e-4, atol=1e-4)
BF16 = dict(rtol=0, atol=3e-2)
IMG, CROP, B, FEAT, NF, NL, NET = 24, 20, 8, 16, 8, 2, 32
T = torch.as_tensor


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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
            return tuple(_t(v) for v in value)
        return _t(value)

    def reset(self, env, n):
        return self._pop("reset")

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


# --- the JAX draws ----------------------------------------------------------
def _pend_reset(k_reset):
    k1, k2 = jax.random.split(k_reset)
    return (jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
            jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))


@jax.jit
def _initial_reset_draws(keys):
    return jax.vmap(lambda k: _pend_reset(jax.random.split(k)[0]))(keys)


@jax.jit
def _step_reset_draws(rngs):
    def one(key):
        _, carry = jax.random.split(key)
        return _pend_reset(jax.random.split(jax.random.split(carry)[1])[0])
    return jax.vmap(one)(rngs)


def _reset(draws):
    return ("reset", tuple(np.asarray(d) for d in draws))


@partial(jax.jit, static_argnums=(1, 2))
def _offsets(key, b, high):
    """JAX crop / translate offsets, (x, y) per image."""
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


def _jitter_draws(key, b):
    """The JAX color jitter's draws as the port's u [6, B]: the order coin
    in row 0's first entry, then take, brightness, contrast, saturation,
    hue as unit uniforms (lo + u * (hi - lo) on both sides)."""
    korder, kp, kb, kc, ks, kh = jax.random.split(key, 6)
    u = np.zeros((6, b), np.float32)
    u[0, 0] = jax.random.uniform(korder, ())
    for row, k in enumerate((kp, kb, kc, ks, kh), start=1):
        u[row] = jax.random.uniform(k, (b,))
    return u


def _aug_draws(key, augs, imgs_shape, out_size):
    """The draws of JAX `apply_augs(key, imgs)` in the port's order."""
    b, h, w, _ = imgs_shape
    seq = []
    for name in augs:
        key, k = jax.random.split(key)
        if name == "crop":
            seq.append(("augment_index",
                        np.asarray(_offsets(k, b, h - out_size))))
        elif name == "translate":
            seq.append(("augment_index",
                        np.asarray(_offsets(k, b, out_size - h))))
        elif name == "cutout":
            bx = np.asarray(_boxes(k, b, h, w))
            seq += [("augment_index", bx[:, i]) for i in range(3)]
        elif name == "grayscale":
            seq.append(("augment_uniform",
                        np.asarray(jax.random.uniform(k, (b, 1, 1, 1)))
                        .reshape(b)))
        elif name == "color_jitter":
            seq.append(("augment_uniform", _jitter_draws(k, b)))
        h = w = out_size if name in ("crop", "translate") else h
    return seq


def _sample_draws(key, batch_size, augs, out_size, cpc, imgs_shape):
    """The draws of JAX `augmented_sample(state, key, ...)`."""
    k_sample, k_obs, k_next, k_anchor, k_pos = jax.random.split(key, 5)
    seq = [("replay", np.asarray(jax.random.uniform(k_sample,
                                                    (batch_size,))))]
    shape = (batch_size,) + tuple(imgs_shape[1:])
    for k in (k_obs, k_next) + ((k_anchor, k_pos) if cpc else ()):
        seq += _aug_draws(k, augs, shape, out_size)
    return seq


def _train_draws(key, batch_size, action_size=1):
    k_next, k_new = jax.random.split(key)
    return ("train", (np.asarray(jax.random.normal(k_next, (batch_size,
                                                             action_size))),
                      np.asarray(jax.random.normal(k_new, (batch_size,
                                                            action_size)))))


# --- 1. the pixel env and the frame stack -----------------------------------
def test_pixel_pendulum_renders_and_steps_as_jax():
    """The 64 px env: reset from the JAX draws, then steps with torques
    across the clamp; frames, dynamics and rewards against the JAX env
    (and tests/test_visual.py's checks: range, a visible rod, the stack
    rolling)."""
    jenv, env = jmake("pendulum_pixels"), make("pendulum_pixels",
                                               device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    state = env.reset(tuple(_t(d) for d in _initial_reset_draws(keys)))
    assert state.obs.shape == (4, 64, 64, 3)
    _close(state.obs.numpy(), np.asarray(jstate.obs), FRAME)
    img = state.obs.numpy()
    assert 0.0 <= img.min() and img.max() <= 1.0 and img.max() > 0.5
    step = jax.jit(jax.vmap(jenv.step))
    for a in (2.0, -3.0, 0.5):
        action = np.full((4, 1), a, np.float32)
        jout = step(jstate, jnp.asarray(action))
        out = env.step(state, _t(action))
        _close(out.obs.numpy(), np.asarray(jout.obs), FRAME, "obs")
        _close(out.state.internal[0].numpy(),
               np.asarray(jout.state.internal[0]), ENV)
        _close(out.reward.numpy(), np.asarray(jout.reward), ENV)
        # the newest frame is new, the older ones moved left
        assert not np.allclose(out.obs[..., 2].numpy(),
                               state.obs[..., 2].numpy())
        np.testing.assert_array_equal(out.obs[..., 0].numpy(),
                                      state.obs[..., 1].numpy())
        jstate, state = jout.state, out.state


def test_pixel_pendulum_vec_autoresets_as_jax():
    """Three 24 px envs cut at 4 steps: the vec env's autoreset selects
    the frames and the frame stack (the [B, H, W, k] internal) with the
    JAX reset draws."""
    jvec = jmake_vec("pendulum_pixels", num_envs=3, image_size=IMG,
                     max_episode_steps=4)
    vec = make_vec("pendulum_pixels", 3, device="cpu", image_size=IMG,
                   max_episode_steps=4)
    key = jax.random.PRNGKey(1)
    jstate = jax.jit(jvec.reset)(key)
    state = vec.reset(tuple(_t(d) for d in _initial_reset_draws(
        jax.random.split(key, 3))))
    rng = np.random.RandomState(0)
    step = jax.jit(jvec.step)
    for _ in range(9):
        action = rng.uniform(-1, 1, (3, 1)).astype(np.float32)
        draws = _step_reset_draws(jstate.rng)
        jstate, jtr = step(jstate, jnp.asarray(action))
        state, tr = vec.step(state, _t(action),
                             tuple(_t(d) for d in draws))
        assert tr.next_obs.shape == (3, IMG, IMG, 3)
        _close(tr.next_obs.numpy(), np.asarray(jtr.next_obs), FRAME)
        _close(state.obs.numpy(), np.asarray(jstate.obs), FRAME)
        _close(state.internal[1].numpy(), np.asarray(jstate.internal[1]),
               FRAME)
        np.testing.assert_array_equal(state.t.numpy(), np.asarray(jstate.t))


@pytest.mark.parametrize("inner,k", [("pendulum", 4), ("pendulum_pixels", 2)])
def test_frame_stack_env_matches_jax(inner, k):
    """tests/test_exploration_wrappers.py::test_frame_stack_env's checks,
    and the port against the JAX wrapper over 3 steps, on vector obs and
    on 24 px frames."""
    kw = {"image_size": IMG} if inner == "pendulum_pixels" else {}
    jenv = JFrameStackEnv(jmake(inner, **kw), k=k)
    env = FrameStackEnv(make(inner, device="cpu", **kw), k=k)
    assert env.observation_size == jenv.observation_size
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jstate = jax.jit(jax.vmap(jenv.reset))(keys)
    state = env.reset(tuple(_t(d) for d in _initial_reset_draws(keys)))
    c = state.obs.shape[-1] // k
    np.testing.assert_array_equal(state.obs[..., :c].numpy(),
                                  state.obs[..., c:2 * c].numpy())
    step = jax.jit(jax.vmap(jenv.step))
    for a in (0.0, 1.5, -2.0):
        action = np.full((2, 1), a, np.float32)
        jout = step(jstate, jnp.asarray(action))
        out = env.step(state, _t(action))
        _close(out.obs.numpy(), np.asarray(jout.obs), FRAME)
        np.testing.assert_array_equal(
            out.obs[..., (k - 2) * c:(k - 1) * c].numpy(),
            state.obs[..., (k - 1) * c:].numpy())
        jstate, state = jout.state, out.state


# --- 2. image rings and augmentations ---------------------------------------
def _imgs(shape, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("name", ["crop", "center_crop", "center_translate",
                                  "translate", "cutout", "grayscale"])
def test_augmentation_matches_jax(name):
    """Each augmentation on 4 frames of 72 px, the JAX draws fed in
    (tests/test_visual.py::test_augmentations_shapes' cases)."""
    imgs = _imgs((4, 72, 72, 3))
    key = jax.random.PRNGKey(0)
    ji = jnp.asarray(imgs)
    if name == "crop":
        want = jaug.random_crop(key, ji, 64)
        got = aug.random_crop(T(imgs), 64, T(_offsets(key, 4, 8)))
    elif name == "center_crop":
        want, got = jaug.center_crop(ji, 64), aug.center_crop(T(imgs), 64)
    elif name == "center_translate":
        want, got = jaug.center_crop(ji, 80), aug.center_crop(T(imgs), 80)
    elif name == "translate":
        want = jaug.random_translate(key, ji, 80)
        got = aug.random_translate(T(imgs), 80, T(_offsets(key, 4, 8)))
    elif name == "cutout":
        want = jaug.random_cutout(key, ji)
        got = aug.random_cutout(T(imgs), T(_boxes(key, 4, 72, 72)))
        assert float((got == 0).sum()) > 0
    else:
        want = jaug.grayscale(key, ji, p=0.5)
        u = np.asarray(jax.random.uniform(key, (4, 1, 1, 1))).reshape(4)
        got = aug.grayscale(T(imgs), T(u), p=0.5)
        assert (u < 0.5).any() and (u >= 0.5).any()
    assert got.shape == want.shape
    # gathers are exact; the channel mean sums in its own order
    _close(got.numpy(), np.asarray(want),
           dict(rtol=0, atol=1e-7) if name == "grayscale" else EXACT)


def test_color_jitter_matches_jax():
    """tests/test_visual.py::test_color_jitter_pixels' checks on the port
    (the HSV round trip against colorsys, p = 0 the identity, identity
    factors the identity), and the jitter of 4 stacks of 3 frames against
    the JAX one from the same draws."""
    import colorsys

    rng = np.random.RandomState(0)
    px = rng.uniform(0.05, 0.95, (32, 3)).astype(np.float32)
    hsv = aug._rgb2hsv(T(px)).numpy()
    expect = np.array([colorsys.rgb_to_hsv(*p) for p in px])
    np.testing.assert_allclose(hsv, expect, atol=1e-4)
    np.testing.assert_allclose(aug._hsv2rgb(T(hsv)).numpy(), px, atol=1e-4)

    imgs = _imgs((4, 16, 16, 9), 1)
    jitter = jax.jit(jaug.color_jitter)
    for seed in (1, 2):          # both orders of the HSV chain and contrast
        key = jax.random.PRNGKey(seed)
        u = T(_jitter_draws(key, 4))
        want = np.asarray(jitter(key, jnp.asarray(imgs)))
        got = aug.color_jitter(T(imgs), u).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert np.abs(got - imgs).max() > 0.01
        assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_array_equal(aug.color_jitter(T(imgs), u, p=0.0).numpy(),
                                  imgs)
    same = aug.color_jitter(T(imgs), u, brightness=0.0, contrast=0.0,
                            saturation=0.0, hue=0.0).numpy()
    np.testing.assert_allclose(same, imgs, atol=1e-3)


@pytest.mark.parametrize("augs", [("crop",), ("crop", "grayscale",
                                              "cutout")])
def test_image_replay_and_augmented_sample_match_jax(augs):
    """An image ring (obs shape [H, W, C]; a uint8 ring alongside) and
    `augmented_sample` with CURL's views, every draw of the JAX sampler
    replayed: obs, next_obs, anchor and positive independently
    augmented (tests/test_visual.py::
    test_image_replay_and_augmented_sample)."""
    shape, out = (48, 48, 3), 40
    ring = replay_init(32, shape, 1, write_batch=4, device="cpu")
    jring = jreplay_init(32, shape, 1, write_batch=4)
    assert ring.data["obs"].shape == (32,) + shape
    u8 = replay_init(32, shape, 1, 4, "cpu", obs_dtype=torch.uint8)
    assert u8.data["next_obs"].dtype == torch.uint8
    add = jax.jit(jreplay_add)
    for i in range(3):
        tr = dict(obs=_imgs((4,) + shape, i),
                  action=np.zeros((4, 1), np.float32),
                  reward=np.arange(4, dtype=np.float32),
                  next_obs=_imgs((4,) + shape, 10 + i),
                  terminal=np.zeros(4, bool), done=np.zeros(4, bool))
        jring = add(jring, JTransition(
            **{k: jnp.asarray(v) for k, v in tr.items()}))
        ring = replay_add(ring, Transition(**{k: T(v) for k, v in
                                              tr.items()}))
    key = jax.random.PRNGKey(4)
    want = jax.jit(partial(jaugmented_sample, batch_size=B, augs=augs,
                           out_size=out, cpc=True))(jring, key)
    noise = _Draws(_sample_draws(key, B, augs, out, True, (B,) + shape))
    got = augmented_sample(ring, noise, B, augs=augs, out_size=out, cpc=True)
    assert not noise.seq
    assert got["observations_pos"].shape == (B, out, out, 3)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


# --- 3. the encoder, the decoder and CNNDisc --------------------------------
def _randomize(variables, seed):
    """Biases and LayerNorm parameters off their zero / one init, so the
    converter's mapping of each shows."""
    leaves, tree = jax.tree.flatten(variables)
    rng = np.random.RandomState(seed)
    leaves = [jnp.asarray(x + 0.1 * rng.randn(*x.shape).astype(np.float32))
              for x in leaves]
    return jax.tree.unflatten(tree, leaves)


def _forward_and_grads(jfn):
    """jitted (f(p, x), d sum(f * w) / d (p, x)) of a flax apply."""
    def fn(p, x, w):
        out, vjp = jax.vjp(jfn, p, x)
        return out, vjp(w)
    return jax.jit(fn)


def _grads_close(jfwd, jparams, port_module, x, leaves_fn, w):
    """The forward and d sum(f * w) / d (params, input), JAX against
    autograd; returns the port's forward."""
    want, (jg, jgx) = jfwd(jparams, jnp.asarray(x), jnp.asarray(w))
    xt = T(x).clone().requires_grad_(True)
    out = port_module(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    params = [t for t, _, _ in leaves_fn(port_module)]
    grads = torch.autograd.grad(torch.sum(out * T(w)), params + [xt])
    got = convert._dump_leaves([
        (g, path, tr) for g, (_, path, tr) in zip(
            grads[:-1], leaves_fn(port_module))])
    _close(got, _np(jg), GRAD, "params")
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **GRAD)
    return out.detach()


def test_encoder_and_decoder_match_jax():
    """Forward and gradient of the float32 encoder (with uint8-range
    frames too: the batch-wide /255) and of the decoder, whose transposed
    kernels are random, so not symmetric, and whose stride-2 output is
    padded at the edge to the image size (tests/test_visual.py::
    test_encoder_decoder_shapes' checks)."""
    enc = PixelEncoder(IMG, 3, torch.Generator().manual_seed(0),
                       feature_dim=FEAT, num_layers=NL, num_filters=NF,
                       compute_dtype=torch.float32)
    jenc = JPixelEncoder(feature_dim=FEAT, num_layers=NL, num_filters=NF,
                         compute_dtype=jnp.float32)
    x = _imgs((B, IMG, IMG, 3))
    jp = _randomize(jax.jit(jenc.init)(jax.random.PRNGKey(0), x), 1)
    convert.encoder_from_jax(enc, _np(jp))
    _close(convert.encoder_to_numpy(enc), _np(jp), EXACT)
    jfwd = _forward_and_grads(jenc.apply)
    w = np.random.RandomState(2).randn(B, FEAT).astype(np.float32)
    for scale in (1.0, 255.0):
        z = _grads_close(jfwd, jp, enc, x * scale, convert._encoder_leaves,
                         w)
        assert z.shape == (B, FEAT) and float(z.abs().max()) <= 1.0

    hw = conv_out_dim(IMG, NL)
    dec = PixelDecoder(hw, 3, FEAT, torch.Generator().manual_seed(1),
                       num_layers=NL, num_filters=NF, out_size=IMG,
                       compute_dtype=torch.float32)
    jdec = JPixelDecoder(out_hw=hw, channels=3, num_layers=NL,
                         num_filters=NF, out_size=IMG,
                         compute_dtype=jnp.float32)
    h = np.random.RandomState(3).randn(B, FEAT).astype(np.float32)
    jdp = _randomize(jax.jit(jdec.init)(jax.random.PRNGKey(1), h), 4)
    kern = np.asarray(jdp["params"]["deconv_out"]["kernel"])
    assert not np.allclose(kern, kern[::-1, ::-1])
    convert.decoder_from_jax(dec, _np(jdp))
    _close(convert.decoder_to_numpy(dec), _np(jdp), EXACT)
    w = np.random.RandomState(5).randn(B, IMG, IMG, 3).astype(np.float32)
    rec = _grads_close(_forward_and_grads(jdec.apply), jdp, dec, h,
                       convert._decoder_leaves, w)
    assert rec.shape == (B, IMG, IMG, 3)
    # the stride-2 output is 2 * hw + 1 wide: the last row is the edge's
    np.testing.assert_array_equal(rec[:, -1].numpy(), rec[:, -2].numpy())


def test_bf16_encoder_tracks_jax():
    """The spec's default bf16 convs: the port's bf16 features against the
    JAX bf16 encoder's and the float32 one's, both at the bf16 pin."""
    x = _imgs((B, IMG, IMG, 3), 7)
    jenc = JPixelEncoder(feature_dim=FEAT, num_layers=NL, num_filters=NF)
    jp = jax.jit(jenc.init)(jax.random.PRNGKey(2), x)
    enc = PixelEncoder(IMG, 3, torch.Generator().manual_seed(0),
                       feature_dim=FEAT, num_layers=NL, num_filters=NF)
    convert.encoder_from_jax(enc, _np(jp))
    got = enc(T(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jenc.apply)(jp, x)),
                               **BF16)
    enc.compute_dtype = torch.float32
    np.testing.assert_allclose(got, enc(T(x)).detach().numpy(), **BF16)


def test_cnn_disc_matches_jax():
    """tests/test_il.py::test_cnn_disc's checks, and forward and gradient
    (parameters, image and action) against the JAX CNNDisc."""
    jdisc = JCNNDisc(num_filters=NF, num_layer_blocks=2, hid_dim=NET,
                     clamp_magnitude=10.0)
    obs, act = _imgs((4, IMG, IMG, 3)), _imgs((4, 2), 1) * 2 - 1
    jp = _randomize(jax.jit(jdisc.init)(jax.random.PRNGKey(0), obs, act), 3)
    disc = CNNDisc((IMG, IMG, 3), 2, torch.Generator().manual_seed(0),
                   num_filters=NF, hid_dim=NET)
    convert.cnn_disc_from_jax(disc, _np(jp))
    _close(convert.cnn_disc_to_numpy(disc), _np(jp), EXACT)
    logits = disc(T(obs), T(act))
    assert logits.shape == (4, 1) and float(logits.abs().max()) <= 10.0
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(jax.jit(jdisc.apply)(jp, obs, act)),
                               **FWD)
    w = np.random.RandomState(1).randn(4, 1).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, o, a: jnp.sum(jdisc.apply(p, o, a) * w),
                          argnums=(0, 1, 2)))(jp, jnp.asarray(obs),
                                              jnp.asarray(act))
    ot, at = (T(v).clone().requires_grad_(True) for v in (obs, act))
    leaves = convert._cnn_disc_leaves(disc)
    grads = torch.autograd.grad(torch.sum(disc(ot, at) * T(w)),
                                [t for t, _, _ in leaves] + [ot, at])
    got = convert._dump_leaves([(g, p, tr) for g, (_, p, tr) in
                                zip(grads[:-2], leaves)])
    _close(got, _np(jg[0])["params"], GRAD)
    np.testing.assert_allclose(grads[-2].numpy(), np.asarray(jg[1]), **GRAD)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg[2]), **GRAD)


# --- 4. SAC-AE's phases and steps --------------------------------------------
CASES = {
    "sac_ae": dict(),
    "curl": dict(cpc_update_freq=1, encdec_update_freq=0),
    "every_step": dict(ac_update_freq=1, target_update_freq=1,
                       cpc_update_freq=1),
}


def _sacae_pair(case, image_size=IMG):
    kw = dict(image_size=image_size, feature_dim=FEAT, num_conv_layers=NL,
              num_filters=NF, conv_dtype="float32", reward_scale=2.0,
              **CASES[case])
    nets = dict(net_size=NET, num_hidden_layers=1)
    return (JSACAE(1, JSACAEConfig(**kw), **nets),
            SACAE(1, SACAEConfig(**kw), device="cpu", **nets))


def _image_batch(seed=0, size=IMG):
    rng = np.random.RandomState(seed)
    img = lambda: rng.uniform(0, 1, (B, size, size, 3)).astype(  # noqa
        np.float32)
    return {"obs": img(), "action": rng.uniform(-1, 1, (B, 1)).astype(
                np.float32),
            "reward": rng.randn(B).astype(np.float32),
            "terminal": (rng.rand(B) < 0.25).astype(np.float32),
            "next_obs": img(), "observations_anchor": img(),
            "observations_pos": img()}


def _jax_sacae_numpy(jstate):
    s = _np(jstate)
    out = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    for k in ("qf_opt", "policy_opt", "alpha_opt", "encdec_opt", "cpc_opt"):
        a = out[k][0]
        out[k] = {"count": int(a.count), "mu": a.mu, "nu": a.nu}
    out["step"] = int(s.step)
    return out


@pytest.fixture(scope="module")
def sacae_start():
    """Per case: the JAX trainer, a state two `train_step`s in (the
    moments, W and the targets off their init) and the port's copy."""
    out = {}
    for case in ("sac_ae", "curl"):
        jalgo, algo = _sacae_pair(case)
        js = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
        step = jax.jit(jalgo.train_step)
        for i in range(2):
            js, _ = step(js, _image_batch(10 + i), jax.random.PRNGKey(i))
        out[case] = (jalgo, algo, js, step)
    return out


@pytest.mark.parametrize("phase", ["ac", "encdec", "cpc"])
def test_train_phase_matches_jax(sacae_start, phase):
    """`_train_ac`, `_train_encdec` and `_train_cpc` alone, from the same
    state and batch; the critic step moves the encoder, the policy step
    does not (tests/test_visual.py::test_encoder_policy_separation)."""
    jalgo, algo, js, _ = sacae_start["curl"]
    state = convert.sac_ae_state_from_jax(algo, _np(js))
    batch = _image_batch(3)
    key = jax.random.PRNGKey(7)
    if phase == "ac":
        jnext, jm = jax.jit(jalgo._train_ac)(js, batch, key)
        _, (en, ew) = _train_draws(key, B)
        enc0 = state.encoder.conv0.weight.detach().clone()
        m = algo._train_ac(state, {k: T(v) for k, v in batch.items()},
                           T(en), T(ew))
        assert not torch.equal(enc0, state.encoder.conv0.weight)
    elif phase == "encdec":
        jnext, jm = jax.jit(jalgo._train_encdec)(js, batch)
        m = algo._train_encdec(state, {k: T(v) for k, v in batch.items()})
    else:
        jnext, jm = jax.jit(jalgo._train_cpc)(js, batch)
        m = algo._train_cpc(state, {k: T(v) for k, v in batch.items()})
    _close({k: float(v) for k, v in m.items()},
           {k: float(v) for k, v in jm.items()}, METRIC)
    _close(convert.sac_ae_state_to_numpy(state), _jax_sacae_numpy(jnext),
           PIN)


def test_policy_step_leaves_the_encoder(sacae_start):
    """The policy's gradient never reaches the encoder (tests/test_visual.py
    ::test_encoder_policy_separation): the encoder after `_train_ac` is the
    one its critic step alone leaves, and the policy moved."""
    jalgo, algo, js, _ = sacae_start["curl"]
    state = convert.sac_ae_state_from_jax(algo, _np(js))
    critic_only = convert.sac_ae_state_from_jax(algo, _np(js))
    critic_only.policy_opt.step = critic_only.alpha_opt.step = \
        lambda grads: None
    policy0 = state.policy.mean.weight.detach().clone()
    batch = {k: T(v) for k, v in _image_batch(4).items()}
    _, (en, ew) = _train_draws(jax.random.PRNGKey(1), B)
    algo._train_ac(state, batch, T(en), T(ew))
    algo._train_ac(critic_only, batch, T(en), T(ew))
    for a, b in zip(state.encoder.parameters(),
                    critic_only.encoder.parameters()):
        assert torch.equal(a, b)
    assert not torch.equal(state.policy.mean.weight, policy0)


@pytest.mark.parametrize("case", ["sac_ae", "curl"])
def test_three_train_steps_match_jax(sacae_start, case):
    """Three staggered `train_step`s (tests/test_visual.py::
    test_sac_ae_train_step and test_sac_ae_curl_step): the skipped phases'
    zeros, alpha, the targets' cadence and the step counter."""
    jalgo, algo, js, step = sacae_start[case]
    state = convert.sac_ae_state_from_jax(algo, _np(js))
    for i in range(3):
        batch = _image_batch(20 + i)
        key = jax.random.PRNGKey(30 + i)
        js, jm = step(js, batch, key)
        _, (en, ew) = _train_draws(key, B)
        state, m = algo.train_step(state, {k: T(v) for k, v in
                                           batch.items()}, T(en), T(ew))
        _close({k: float(v) for k, v in m.items()},
               {k: float(v) for k, v in jm.items()}, METRIC)
        assert all(np.isfinite(float(v)) for v in m.values())
    assert state.step == int(js.step) == 5
    _close(convert.sac_ae_state_to_numpy(state), _jax_sacae_numpy(js), PIN)


# --- 5. the loop with RAD's sampler, and the launcher ------------------------
NE, KG = 4, 1


SPECS = [ROOT / "exp_specs" / d / f"{d}_pendulum_pixels.yaml"
         for d in ("sac_ae", "sac_rad", "sac_curl")]


def _spec(path):
    with open(path) as f:
        spec = yaml.safe_load(f)
    return dict(spec["constants"], seed=0, print_to_console=False)


def _built(run, cls, variant, log_dir, **kw):
    """The trainer and loop `run` builds from `variant`, stopped at the
    loop's `init`."""
    seen = {}

    class Stop(Exception):
        pass

    loop_cls = JLoop if cls is JSACAE else OffPolicyLoop

    def init(self, *args, **kwargs):
        seen["loop"] = self
        raise Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop_cls, "init", init)
        with pytest.raises(Stop):
            run(dict(variant, log_dir=str(log_dir)), **kw)
    return seen["loop"]


@pytest.mark.parametrize("spec", SPECS, ids=lambda p: p.parent.name)
def test_run_sac_ae_reads_the_specs_as_the_jax_launcher(tmp_path, spec):
    """The SACAEConfig, nets, loop configuration, crop and sampler
    `run_sac_ae` builds from each pendulum_pixels spec, against the JAX
    launcher's."""
    v = _spec(spec)
    p = _built(pexp.run_sac_ae, SACAE, v, tmp_path / "port", device="cpu")
    j = _built(jexp.run_sac_ae, JSACAE, v, tmp_path / "jax")
    # the JAX loop holds the trainer, or its center-cropping wrapper,
    # whose `init` is the trainer's bound method
    palgo, jalgo = p.algo.algo, j.algo.init.__self__
    assert dataclasses.asdict(palgo.config) == \
        dataclasses.asdict(jalgo.config)
    assert palgo.hidden == (v["net_size"],) * v["num_hidden_layers"]
    assert dataclasses.asdict(p.config) == dataclasses.asdict(j.config)
    assert p.grad_steps_per_iter == j.grad_steps_per_iter == 8
    augs = bool(v.get("augs"))
    assert (p.sample_fn.keywords if augs else None) == (
        j.sample_fn.keywords if augs else None)
    assert palgo.config.image_size == (56 if augs else 64)
    frames = torch.zeros((2, 64, 64, 3))
    assert p.algo.view(frames).shape[1] == palgo.config.image_size


def _cut_curl(tmp_path, name):
    """sac_curl_pendulum_pixels.yaml at RAD's crop, cut to 4 envs of 24 px
    (crop 20), 2 convs of 8, 32 x 1 nets, K = 1 at batch 8, one warmup and
    two training iterations in one epoch, 3-step episodes and evaluation,
    the autoencoder on as well."""
    v = _spec(SPECS[2])
    v.update(net_size=NET, num_hidden_layers=1, feature_dim=FEAT,
             num_conv_layers=NL, num_filters=NF, crop_size=CROP,
             log_dir=str(tmp_path / name))
    v["env_specs"] = dict(v["env_specs"], env_num=NE,
                          env_kwargs={"image_size": IMG})
    v["sac_params"] = dict(v["sac_params"], encdec_update_freq=1)
    v["rl_alg_params"] = dict(
        v["rl_alg_params"], num_epochs=1, num_steps_per_epoch=2 * NE,
        min_steps_before_training=NE, num_train_steps_per_train_call=250,
        max_path_length=3, batch_size=B, replay_buffer_size=64)
    return v


def test_run_sac_ae_epoch_matches_jax(tmp_path, monkeypatch):
    """One epoch of `run_sac_ae` through the launcher against the JAX
    launcher's on the CPU, at RAD's crop with CURL's views (`_cut_curl`):
    the port's runner starts from the JAX launcher's initial runner, and
    every draw of the JAX warmup, training iterations (acting on the
    center crop, the augmented sampler, the steps) and evaluation is
    replayed in the port's order.  progress.csv's metrics and evaluation
    and the end states agree.  Both launchers build their trainer with
    float32 convs here (they never set `conv_dtype`; the bf16 default is
    held by `test_bf16_encoder_tracks_jax`)."""
    import ilswiss_tpu.algorithms.sac_ae as jsac_ae
    import ilswiss_tpu_torch.algorithms.sac_ae as psac_ae

    monkeypatch.chdir(tmp_path)
    for mod, cfg in ((jsac_ae, JSACAEConfig), (psac_ae, SACAEConfig)):
        monkeypatch.setattr(mod, "SACAEConfig",
                            partial(cfg, conv_dtype="float32"))
    v = _cut_curl(tmp_path, "jax")
    started = []
    jinit = JLoop.init

    def keep(self, key):
        out = jax.jit(jinit, static_argnums=0)(self, key)
        started.append(jax.tree.map(np.array, out))   # before donation
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JLoop, "init", keep)
        jr = _np(jexp.run_sac_ae(dict(v)))
    start = started[0]

    # the draws: the env rngs do not depend on the actions, so a JAX vec
    # env stepped with zeros from the same state gives the reset draws
    jvec = jmake_vec("pendulum_pixels", num_envs=NE, image_size=IMG,
                     max_episode_steps=3)
    jstep = jax.jit(lambda s: jvec.step(s, jnp.zeros((NE, 1)))[0])
    env = jax.tree.map(jnp.asarray, start.env_state)
    rng, seq = jnp.asarray(start.rng), []

    def collect(kind, value):
        nonlocal env
        seq.extend([(kind, value), _reset(_step_reset_draws(env.rng))])
        env = jstep(env)

    rng, k_act = jax.random.split(rng)
    collect("warmup_action", np.asarray(jax.random.uniform(
        k_act, (NE, 1), minval=-1.0, maxval=1.0)))
    for _ in range(2):
        rng, k_act = jax.random.split(rng)
        collect("act", np.asarray(jax.random.normal(k_act, (NE, 1))))
        rng, k_steps = jax.random.split(rng)
        for key in jax.random.split(k_steps, 1):
            k_samp, k_train = jax.random.split(key)
            seq += _sample_draws(k_samp, B, ("crop",), CROP, True,
                                 (B, IMG, IMG, 3))
            seq.append(_train_draws(k_train, B))
    k_reset, _ = jax.random.split(jax.random.PRNGKey(1))
    env = jax.jit(jvec.reset)(k_reset)
    evals = [_reset(_initial_reset_draws(jax.random.split(k_reset, NE)))]
    for _ in range(3):
        evals.append(_reset(_step_reset_draws(env.rng)))
        env = jstep(env)

    def port_init(self, seed, noise=None):
        return RunnerState(
            noise=_Draws(seq),
            env_state=convert.env_state_from_jax(start.env_state, "cpu"),
            replay=replay_init(self.config.replay_capacity, (IMG, IMG, 3),
                               1, NE, "cpu"),
            algo_state=convert.sac_ae_state_from_jax(self.algo.algo,
                                                     start.algo_state),
            total_env_steps=0)

    monkeypatch.setattr(OffPolicyLoop, "init", port_init)
    monkeypatch.setattr(pexp, "Noise", lambda seed, device: _Draws(evals))
    runner = pexp.run_sac_ae(_cut_curl(tmp_path, "port"), device="cpu")
    assert not runner.noise.seq
    rows = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "progress.csv") as f:
            (rows[name],) = list(csv.DictReader(f))
    keys = set(rows["jax"]) - {"TrainTime", "WallTime", "Epoch"}
    assert keys and keys <= set(rows["port"])
    _close({k: float(rows["port"][k]) for k in keys},
           {k: float(rows["jax"][k]) for k in keys}, METRIC)
    assert float(rows["port"]["TotalEnvSteps"]) == 3 * NE
    assert runner.algo_state.step == 2
    _close(convert.sac_ae_state_to_numpy(runner.algo_state),
           _jax_sacae_numpy(jr.algo_state), PIN)
    _close(runner.env_state.obs.numpy(), jr.env_state.obs, FRAME)
    _close(runner.replay.data["obs"].numpy(), jr.replay.data["obs"], FRAME)


def test_run_sac_ae_trains_logs_and_snapshots(tmp_path, monkeypatch):
    """A cut copy of sac_curl_pendulum_pixels.yaml at RAD's crop (24 px
    frames cropped to 20, CURL's views) through the CLI's launcher on the
    CPU: progress.csv with finite trainer metrics, AverageReturn,
    TrainTime and EvalTime, and the snapshots."""
    monkeypatch.chdir(tmp_path)
    v = _spec(SPECS[2])
    v.update(net_size=NET, num_hidden_layers=1, feature_dim=FEAT,
             num_conv_layers=NL, num_filters=NF, crop_size=CROP,
             log_dir=str(tmp_path / "log"))
    v["env_specs"] = dict(v["env_specs"], env_num=NE,
                          env_kwargs={"image_size": IMG})
    v["sac_params"] = dict(v["sac_params"], encdec_update_freq=1)
    v["rl_alg_params"] = dict(
        v["rl_alg_params"], num_epochs=2, num_steps_per_epoch=2 * NE,
        min_steps_before_training=2 * NE, max_path_length=6, batch_size=B,
        replay_buffer_size=64)
    runner = pexp.EXPERIMENTS["sac_curl"](v, device="cpu")
    assert runner.algo_state.step == 2 * 2 * 2
    with open(tmp_path / "log" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    for key in ("trainer/qf1_loss", "trainer/curl_loss", "trainer/rec_loss",
                "trainer/alpha", "AverageReturn", "TrainTime", "EvalTime"):
        assert all(np.isfinite(float(r[key])) for r in rows), key
    assert [float(r["TotalEnvSteps"]) for r in rows] == [16.0, 24.0]
    ckpt = tmp_path / "log" / "checkpoints"
    assert (ckpt / "last").is_dir() and (ckpt / "best").is_dir()


# --- 6. the visual AdvIRL ----------------------------------------------------
class _JFlatSAC:
    """tests/test_il.py's adapter: the inner SAC sees flat obs / 255."""

    def __init__(self, sac):
        self.sac = sac

    def init(self, key):
        return self.sac.init(key)

    def act(self, state, obs, key, deterministic=False):
        return self.sac.act(state, obs.reshape(obs.shape[0], -1) / 255.0,
                            key, deterministic=deterministic)

    def train_step(self, state, batch, key):
        b = dict(batch)
        for k in ("obs", "next_obs"):
            b[k] = batch[k].reshape(batch[k].shape[0], -1) / 255.0
        return self.sac.train_step(state, b, key)


class _FlatSAC:
    """The port's adapter of the same."""

    def __init__(self, sac):
        self.sac, self.device = sac, sac.device
        self.init, self.act_noise = sac.init, sac.act_noise

    def act(self, state, obs, eps=None, deterministic=False):
        return self.sac.act(state, obs.reshape(obs.shape[0], -1) / 255.0,
                            eps, deterministic=deterministic)

    def train_step(self, state, batch, eps_next, eps_new):
        b = dict(batch)
        for k in ("obs", "next_obs"):
            b[k] = batch[k].reshape(batch[k].shape[0], -1) / 255.0
        return self.sac.train_step(state, b, eps_next, eps_new)


CNN_CFG = dict(mode="gail", disc_type="cnn", disc_hid_dim=NET,
               disc_num_blocks=2, disc_num_filters=NF,
               disc_optim_batch_size=B, policy_optim_batch_size=B,
               grad_pen_weight=1.0, disc_lr=1e-3)


def test_cnn_disc_update_and_policy_update_match_jax():
    """AdvIRL with the cnn discriminator on 24 px frames: one
    discriminator step (the penalty over image and action together) and
    one policy step on its rewards, from the JAX draws."""
    obs_dim = IMG * IMG * 3
    rng = np.random.RandomState(0)
    rows = 32
    data = {"obs": rng.uniform(0, 1, (rows, IMG, IMG, 3)),
            "action": rng.uniform(-1, 1, (rows, 1)),
            "reward": rng.randn(rows), "terminal": np.zeros(rows),
            "next_obs": rng.uniform(0, 1, (rows, IMG, IMG, 3))}
    data = {k: np.asarray(v, np.float32) for k, v in data.items()}

    def ring(shift):
        r = jreplay_init(rows, (IMG, IMG, 3), 1, write_batch=4)
        return r.replace(data={k: jnp.asarray(np.roll(v, shift, 0))
                               for k, v in data.items()},
                         size=jnp.asarray(rows, jnp.int32))
    jexpert, jreplay = ring(0), ring(5)
    jsac = JSAC(obs_dim, 1, JSACConfig(), net_size=NET, num_hidden_layers=1)
    jalgo = JAdvIRL(obs_dim, 1, _JFlatSAC(jsac), jexpert,
                    JAdvIRLConfig(**CNN_CFG))
    js = jax.jit(jalgo.init)(jax.random.PRNGKey(0))
    sac = SAC(obs_dim, 1, SACConfig(), net_size=NET, num_hidden_layers=1,
              device="cpu")
    algo = AdvIRL(obs_dim, 1, _FlatSAC(sac), convert.replay_from_jax(
        _np(jexpert), "cpu"), AdvIRLConfig(**CNN_CFG))
    state = convert.adv_irl_state_from_jax(algo, _np(js))
    replay = convert.replay_from_jax(_np(jreplay), "cpu")

    key = jax.random.PRNGKey(5)
    k_e, k_p, k_eps = jax.random.split(key, 3)
    js, jm = jax.jit(jalgo._disc_update)(js, jreplay, key)
    noise = _Draws([("replay", np.asarray(jax.random.uniform(k_e, (B,)))),
                    ("replay", np.asarray(jax.random.uniform(k_p, (B,)))),
                    ("interpolation",
                     np.asarray(jax.random.uniform(k_eps, (B, 1))))])
    state, m = algo._disc_update(state, replay, noise)
    assert not noise.seq and float(jm["disc_grad_pen"]) > 0
    _close({k: float(v) for k, v in m.items()},
           {k: float(v) for k, v in jm.items()}, METRIC)

    key = jax.random.PRNGKey(6)
    k_p, _, k_t = jax.random.split(key, 3)
    js, jm = jax.jit(jalgo._policy_update)(js, jreplay, key)
    noise = _Draws([("replay", np.asarray(jax.random.uniform(k_p, (B,)))),
                    _train_draws(k_t, B)])
    state, m = algo._policy_update(state, replay, noise)
    assert not noise.seq
    _close({k: float(v) for k, v in m.items()},
           {k: float(v) for k, v in jm.items()}, METRIC)
    got = convert.adv_irl_state_to_numpy(state)
    want = _np(js)
    _close(got["disc_params"], want.disc_params, PIN)
    _close(got["disc_opt"]["mu"], want.disc_opt[0].mu, PIN)
    _close(got["policy"]["policy_params"], want.policy.policy_params, PIN)


def test_visual_gail_cnn_disc_epoch():
    """tests/test_il.py::test_visual_gail_cnn_disc_epoch on the port: GAIL
    with the cnn discriminator on pendulum_pixels (64 px), demos of image
    transitions, one loop epoch, finite metrics."""
    vec = make_vec("pendulum_pixels", 2, device="cpu")
    noise = Noise(3, "cpu")
    demos = collect_transitions(
        vec, lambda obs, n: n.warmup_action((2, 1)), 60, noise)
    obs_dim = int(np.prod(vec.env.observation_size))
    sac = SAC(obs_dim, 1, SACConfig(), net_size=NET, num_hidden_layers=1,
              device="cpu")
    gail = AdvIRL(obs_dim, 1, _FlatSAC(sac), demos, AdvIRLConfig(
        **dict(CNN_CFG, disc_optim_batch_size=16,
               policy_optim_batch_size=16)))
    loop = OffPolicyLoop(vec, gail, OffPolicyConfig(
        batch_size=16, replay_capacity=512, min_steps_before_training=16))
    runner = loop.warmup(loop.init(0))
    runner, metrics = loop.train_epoch(runner, 8)
    for k in ("disc_ce_loss", "disc_acc", "disc_rew_mean"):
        assert np.isfinite(metrics[k]), k
    assert metrics["disc_rew_mean"] >= 0.0


def test_feature_fn_feeds_the_discriminator():
    """`feature_fn` (the visual AdvIRL's encoder features): an mlp
    discriminator of width feature_dim + A sees the detached features of
    the obs (and of next_obs with `state_only`), as the JAX `_disc_input`
    builds them."""
    sac = SAC(3, 1, SACConfig(), net_size=NET, num_hidden_layers=1,
              device="cpu")
    w = torch.randn(3, 5, requires_grad=True)
    feats = lambda s, o: torch.tanh(o @ w)  # noqa: E731
    rng = np.random.RandomState(0)
    batch = {k: T(rng.randn(4, n).astype(np.float32)) for k, n in
             (("obs", 3), ("next_obs", 3), ("action", 1))}
    for state_only in (False, True):
        algo = AdvIRL(3, 1, sac, None, AdvIRLConfig(
            state_only=state_only, disc_use_bn=False), feature_fn=feats,
            feature_dim=5)
        x = algo._disc_input(types.SimpleNamespace(policy=None), batch)
        other = feats(None, batch["next_obs"]) if state_only \
            else batch["action"]
        want = torch.cat([feats(None, batch["obs"]), other], -1)
        assert x.shape == (4, algo.disc_input_dim) and not x.requires_grad
        torch.testing.assert_close(x, want.detach())
