// mjvec: native vectorized MuJoCo engine (envpool-style).
//
// The framework's C++ replacement for the reference's external native
// dependencies (envpool's C++ batched env engine / mujoco-py; SURVEY.md
// §2.4): B MuJoCo env instances stepped in one call over persistent
// worker stripes, with gymnasium-v5-exact observation/reward/termination
// semantics for the locomotion family and immediate autoreset.  The
// Python side (envs/native_mujoco.py) binds via ctypes — no pybind11.
//
// Semantics mirrored from gymnasium v5 (verified against the installed
// sources, see tests/test_native_mujoco.py):
//   hopper_v5.py:    obs = [qpos[1:], clip(qvel, ±10)]; reward =
//                    x_vel + healthy - 1e-3*|a|²; healthy: z>0.7,
//                    |angle|<0.2, state[2:] in ±100; frame_skip 4
//   walker2d_v5.py:  same obs; healthy: 0.8<z<2.0, |angle|<1; skip 4
//   half_cheetah_v5: obs = [qpos[1:], qvel]; reward = x_vel - 0.1*|a|²;
//                    never terminates; frame_skip 5; reset noise:
//                    qpos uniform(±.1), qvel N(0,.1)
//   ant_v5:          obs = [qpos[2:], qvel, clip(cfrc_ext[1:], ±1)];
//                    reward = x_vel(torso xpos) + healthy
//                    - 0.5*|a|² - 5e-4*Σclip(cfrc)²; healthy: finite
//                    state, 0.2<=z<=1.0; skip 5; noise q±.1, qd N(0,.1)
//   humanoid_v5:     obs = [qpos[2:], qvel, cinert[1:], cvel[1:],
//                    qfrc_actuator[6:], cfrc_ext[1:]]; reward =
//                    1.25*com_x_vel + 5*healthy - 0.1*|ctrl|²
//                    - min(5e-7*Σcfrc², 10); healthy: 1<z<2; skip 5;
//                    noise uniform ±.01 on q and qd
//   swimmer_v5:      obs = [qpos[2:], qvel]; reward = x_vel - 1e-4*|a|²;
//                    never terminates; skip 4; noise uniform ±.1
//   inverted_pendulum_v5:        obs = [qpos, qvel]; reward = 1 while
//                    healthy (finite, |angle|<=0.2); skip 2; noise ±.01
//   inverted_double_pendulum_v5: obs = [x, sin q12, cos q12,
//                    clip(qvel,±10), clip(qfrc_constraint,±10)[0]];
//                    reward = 10*healthy - (0.01 x_tip² + (y_tip-2)²)
//                    - (1e-3 w1² + 5e-3 w2²); terminal y_tip<=1;
//                    skip 5; noise q±.1 uniform, qd N(0,.1)
// Like gymnasium's MujocoEnv._step_mujoco_simulation, one
// mj_rnePostConstraint call follows the frame_skip block so
// force-derived quantities (cfrc_ext, cacc) are populated.
//
// Build: see envs/native_mujoco.py (g++ -O3 -shared, links the wheel's
// libmujoco).

#include <mujoco/mujoco.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

enum EnvType {
  HOPPER = 0,
  WALKER2D = 1,
  HALFCHEETAH = 2,
  ANT = 3,
  HUMANOID = 4,
  SWIMMER = 5,
  INVPEND = 6,
  INVDBLPEND = 7,
};

struct VecEnv {
  mjModel* model = nullptr;
  std::vector<mjData*> data;
  int n = 0;
  int env_type = 0;
  int frame_skip = 4;
  int max_steps = 1000;
  double dt = 0.0;
  int nq = 0, nv = 0, nu = 0, obs_dim = 0;
  std::vector<double> init_qpos, init_qvel;
  std::vector<std::mt19937> rng;
  std::vector<int> step_count;

  // persistent worker pool
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  int generation = 0;
  int pending = 0;
  bool shutdown = false;
  const float* cur_actions = nullptr;
  float* out_true_next = nullptr;
  float* out_reward = nullptr;
  uint8_t* out_terminal = nullptr;
  uint8_t* out_done = nullptr;
  float* out_obs_after = nullptr;
};

double reset_noise_scale(const VecEnv* env) {
  switch (env->env_type) {
    case HALFCHEETAH: case ANT: case SWIMMER: case INVDBLPEND: return 0.1;
    case HUMANOID: case INVPEND: return 0.01;
    default: return 5e-3;  // hopper/walker2d
  }
}

// halfcheetah/ant/inverteddoublependulum draw qvel ~ scale*N(0,1);
// the rest draw uniform(-scale, scale)
bool gaussian_qvel_noise(const VecEnv* env) {
  return env->env_type == HALFCHEETAH || env->env_type == ANT ||
         env->env_type == INVDBLPEND;
}

double clipd(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

void write_obs(const VecEnv* env, int i, float* out) {
  const mjModel* m = env->model;
  const mjData* d = env->data[i];
  int k = 0;
  switch (env->env_type) {
    case HOPPER:
    case WALKER2D:
      for (int j = 1; j < env->nq; ++j) out[k++] = (float)d->qpos[j];
      for (int j = 0; j < env->nv; ++j)
        out[k++] = (float)clipd(d->qvel[j], -10.0, 10.0);
      break;
    case HALFCHEETAH:
      for (int j = 1; j < env->nq; ++j) out[k++] = (float)d->qpos[j];
      for (int j = 0; j < env->nv; ++j) out[k++] = (float)d->qvel[j];
      break;
    case ANT:
      for (int j = 2; j < env->nq; ++j) out[k++] = (float)d->qpos[j];
      for (int j = 0; j < env->nv; ++j) out[k++] = (float)d->qvel[j];
      for (int j = 6; j < 6 * m->nbody; ++j)
        out[k++] = (float)clipd(d->cfrc_ext[j], -1.0, 1.0);
      break;
    case HUMANOID:
      for (int j = 2; j < env->nq; ++j) out[k++] = (float)d->qpos[j];
      for (int j = 0; j < env->nv; ++j) out[k++] = (float)d->qvel[j];
      for (int j = 10; j < 10 * m->nbody; ++j)
        out[k++] = (float)d->cinert[j];
      for (int j = 6; j < 6 * m->nbody; ++j)
        out[k++] = (float)d->cvel[j];
      for (int j = 6; j < env->nv; ++j)
        out[k++] = (float)d->qfrc_actuator[j];
      for (int j = 6; j < 6 * m->nbody; ++j)
        out[k++] = (float)d->cfrc_ext[j];
      break;
    case SWIMMER:
      for (int j = 2; j < env->nq; ++j) out[k++] = (float)d->qpos[j];
      for (int j = 0; j < env->nv; ++j) out[k++] = (float)d->qvel[j];
      break;
    case INVPEND:
      for (int j = 0; j < env->nq; ++j) out[k++] = (float)d->qpos[j];
      for (int j = 0; j < env->nv; ++j) out[k++] = (float)d->qvel[j];
      break;
    case INVDBLPEND:
      out[k++] = (float)d->qpos[0];
      for (int j = 1; j < env->nq; ++j)
        out[k++] = (float)std::sin(d->qpos[j]);
      for (int j = 1; j < env->nq; ++j)
        out[k++] = (float)std::cos(d->qpos[j]);
      for (int j = 0; j < env->nv; ++j)
        out[k++] = (float)clipd(d->qvel[j], -10.0, 10.0);
      out[k++] = (float)clipd(d->qfrc_constraint[0], -10.0, 10.0);
      break;
  }
}

bool is_healthy(const VecEnv* env, int i) {
  const mjData* d = env->data[i];
  switch (env->env_type) {
    case HALFCHEETAH:
    case SWIMMER:
      return true;
    case HOPPER: {
      double z = d->qpos[1], angle = d->qpos[2];
      // state_vector()[2:] = qpos[2:] + qvel, all within ±100
      for (int j = 2; j < env->nq; ++j)
        if (!(std::fabs(d->qpos[j]) < 100.0)) return false;
      for (int j = 0; j < env->nv; ++j)
        if (!(std::fabs(d->qvel[j]) < 100.0)) return false;
      return z > 0.7 && std::fabs(angle) < 0.2;
    }
    case WALKER2D: {
      double z = d->qpos[1], angle = d->qpos[2];
      return z > 0.8 && z < 2.0 && angle > -1.0 && angle < 1.0;
    }
    case ANT: {
      for (int j = 0; j < env->nq; ++j)
        if (!std::isfinite(d->qpos[j])) return false;
      for (int j = 0; j < env->nv; ++j)
        if (!std::isfinite(d->qvel[j])) return false;
      return d->qpos[2] >= 0.2 && d->qpos[2] <= 1.0;
    }
    case HUMANOID:
      return d->qpos[2] > 1.0 && d->qpos[2] < 2.0;
    case INVPEND: {
      for (int j = 0; j < env->nq; ++j)
        if (!std::isfinite(d->qpos[j])) return false;
      for (int j = 0; j < env->nv; ++j)
        if (!std::isfinite(d->qvel[j])) return false;
      return std::fabs(d->qpos[1]) <= 0.2;
    }
    case INVDBLPEND:
      // site 0 is the pole-2 tip in inverted_double_pendulum.xml
      return d->site_xpos[2] > 1.0;
  }
  return true;
}

// COM of the whole model (gym humanoid mass_center): mass-weighted xipos
void mass_center_xy(const VecEnv* env, int i, double* xy) {
  const mjModel* m = env->model;
  const mjData* d = env->data[i];
  double tot = 0.0, x = 0.0, y = 0.0;
  for (int b = 0; b < m->nbody; ++b) {
    double mass = m->body_mass[b];
    tot += mass;
    x += mass * d->xipos[3 * b];
    y += mass * d->xipos[3 * b + 1];
  }
  xy[0] = x / tot;
  xy[1] = y / tot;
}

void reset_one(VecEnv* env, int i) {
  mjData* d = env->data[i];
  mj_resetData(env->model, d);
  double s = reset_noise_scale(env);
  std::uniform_real_distribution<double> uni(-s, s);
  std::normal_distribution<double> normal(0.0, 1.0);
  auto& gen = env->rng[i];
  for (int j = 0; j < env->nq; ++j)
    d->qpos[j] = env->init_qpos[j] + uni(gen);
  if (gaussian_qvel_noise(env)) {
    for (int j = 0; j < env->nv; ++j)
      d->qvel[j] = env->init_qvel[j] + s * normal(gen);
  } else {
    for (int j = 0; j < env->nv; ++j)
      d->qvel[j] = env->init_qvel[j] + uni(gen);
  }
  mj_forward(env->model, d);
  // NOTE: gym's reset does NOT call mj_rnePostConstraint, so the reset
  // observation's cfrc_ext entries are the zeros left by mj_resetData —
  // reproduced here by doing nothing.
  env->step_count[i] = 0;
}

void step_one(VecEnv* env, int i) {
  const mjModel* m = env->model;
  mjData* d = env->data[i];
  const float* a = env->cur_actions + (size_t)i * env->nu;

  // forward-progress reference point, measured the way gym measures it
  double before[2] = {d->qpos[0], 0.0};
  if (env->env_type == ANT) {
    before[0] = d->xpos[3 * 1];       // torso body xpos (main_body=1)
    before[1] = d->xpos[3 * 1 + 1];
  } else if (env->env_type == HUMANOID) {
    mass_center_xy(env, i, before);
  }

  for (int j = 0; j < env->nu; ++j) {
    // normalized [-1,1] -> ctrlrange (gym action space == ctrlrange)
    double lo = m->actuator_ctrlrange[2 * j];
    double hi = m->actuator_ctrlrange[2 * j + 1];
    double act = lo + (a[j] + 1.0) * 0.5 * (hi - lo);
    act = act < lo ? lo : (act > hi ? hi : act);
    d->ctrl[j] = act;
  }
  for (int s = 0; s < env->frame_skip; ++s) mj_step(m, d);
  // gym MujocoEnv._step_mujoco_simulation follows the frame_skip block
  // with one mj_rnePostConstraint so cfrc_ext/cacc are populated
  mj_rnePostConstraint(m, d);

  double after[2] = {d->qpos[0], 0.0};
  if (env->env_type == ANT) {
    after[0] = d->xpos[3 * 1];
    after[1] = d->xpos[3 * 1 + 1];
  } else if (env->env_type == HUMANOID) {
    mass_center_xy(env, i, after);
  }
  double x_vel = (after[0] - before[0]) / env->dt;

  double ctrl_cost = 0.0;
  for (int j = 0; j < env->nu; ++j) ctrl_cost += d->ctrl[j] * d->ctrl[j];

  bool healthy = is_healthy(env, i);
  double reward = 0.0;
  bool terminal = false;
  switch (env->env_type) {
    case HOPPER:
    case WALKER2D:
      reward = x_vel + (healthy ? 1.0 : 0.0) - 1e-3 * ctrl_cost;
      terminal = !healthy;
      break;
    case HALFCHEETAH:
      reward = x_vel - 0.1 * ctrl_cost;
      break;
    case ANT: {
      double contact = 0.0;
      for (int j = 0; j < 6 * m->nbody; ++j) {
        double f = clipd(d->cfrc_ext[j], -1.0, 1.0);
        contact += f * f;
      }
      reward = x_vel + (healthy ? 1.0 : 0.0) - 0.5 * ctrl_cost
               - 5e-4 * contact;
      terminal = !healthy;
      break;
    }
    case HUMANOID: {
      double contact = 0.0;
      for (int j = 0; j < 6 * m->nbody; ++j)
        contact += d->cfrc_ext[j] * d->cfrc_ext[j];
      double contact_cost = 5e-7 * contact;
      if (contact_cost > 10.0) contact_cost = 10.0;
      reward = 1.25 * x_vel + (healthy ? 5.0 : 0.0) - 0.1 * ctrl_cost
               - contact_cost;
      terminal = !healthy;
      break;
    }
    case SWIMMER:
      reward = x_vel - 1e-4 * ctrl_cost;
      break;
    case INVPEND:
      terminal = !healthy;
      reward = terminal ? 0.0 : 1.0;
      break;
    case INVDBLPEND: {
      double x = d->site_xpos[0], y = d->site_xpos[2];
      terminal = y <= 1.0;
      double dist_penalty = 0.01 * x * x + (y - 2.0) * (y - 2.0);
      double v1 = d->qvel[1], v2 = d->qvel[2];
      double vel_penalty = 1e-3 * v1 * v1 + 5e-3 * v2 * v2;
      reward = (terminal ? 0.0 : 10.0) - dist_penalty - vel_penalty;
      break;
    }
  }
  env->step_count[i] += 1;
  bool truncated = env->step_count[i] >= env->max_steps && !terminal;
  bool done = terminal || truncated;

  write_obs(env, i, env->out_true_next + (size_t)i * env->obs_dim);
  env->out_reward[i] = (float)reward;
  env->out_terminal[i] = terminal ? 1 : 0;
  env->out_done[i] = done ? 1 : 0;
  if (done) reset_one(env, i);
  write_obs(env, i, env->out_obs_after + (size_t)i * env->obs_dim);
}

void worker_loop(VecEnv* env, int begin, int end) {
  int seen = 0;
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(env->mu);
      env->cv_work.wait(lk, [&] {
        return env->shutdown || env->generation > seen;
      });
      if (env->shutdown) return;
      seen = env->generation;
    }
    for (int i = begin; i < end; ++i) step_one(env, i);
    {
      std::lock_guard<std::mutex> lk(env->mu);
      if (--env->pending == 0) env->cv_done.notify_one();
    }
  }
}

}  // namespace

extern "C" {

void* mjvec_create(const char* xml_path, int n, int env_type,
                   int frame_skip, int max_steps, unsigned seed,
                   int num_threads) {
  char error[512];
  mjModel* model = mj_loadXML(xml_path, nullptr, error, sizeof(error));
  if (!model) return nullptr;

  auto* env = new VecEnv;
  env->model = model;
  env->n = n;
  env->env_type = env_type;
  env->frame_skip = frame_skip;
  env->max_steps = max_steps;
  env->dt = model->opt.timestep * frame_skip;
  env->nq = model->nq;
  env->nv = model->nv;
  env->nu = model->nu;
  switch (env_type) {
    case ANT:
      env->obs_dim = (model->nq - 2) + model->nv + 6 * (model->nbody - 1);
      break;
    case HUMANOID:
      env->obs_dim = (model->nq - 2) + model->nv
                     + 10 * (model->nbody - 1)   // cinert
                     + 6 * (model->nbody - 1)    // cvel
                     + (model->nv - 6)           // qfrc_actuator
                     + 6 * (model->nbody - 1);   // cfrc_ext
      break;
    case SWIMMER:
      env->obs_dim = (model->nq - 2) + model->nv;
      break;
    case INVPEND:
      env->obs_dim = model->nq + model->nv;
      break;
    case INVDBLPEND:
      env->obs_dim = 1 + 2 * (model->nq - 1) + model->nv + 1;
      break;
    default:
      env->obs_dim = (model->nq - 1) + model->nv;
  }
  env->init_qpos.assign(model->qpos0, model->qpos0 + model->nq);
  env->init_qvel.assign(model->nv, 0.0);

  std::mt19937 seeder(seed);
  for (int i = 0; i < n; ++i) {
    env->data.push_back(mj_makeData(model));
    env->rng.emplace_back(seeder());
    env->step_count.push_back(0);
  }
  for (int i = 0; i < n; ++i) reset_one(env, i);

  int nthreads = num_threads < 1 ? 1 : (num_threads > n ? n : num_threads);
  int per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int b = t * per, e = b + per > n ? n : b + per;
    if (b >= e) break;
    env->workers.emplace_back(worker_loop, env, b, e);
  }
  return env;
}

int mjvec_obs_dim(void* h) { return ((VecEnv*)h)->obs_dim; }
int mjvec_act_dim(void* h) { return ((VecEnv*)h)->nu; }

void mjvec_reset_all(void* h, float* obs_out) {
  auto* env = (VecEnv*)h;
  for (int i = 0; i < env->n; ++i) {
    reset_one(env, i);
    write_obs(env, i, obs_out + (size_t)i * env->obs_dim);
  }
}

void mjvec_get_obs(void* h, float* obs_out) {
  auto* env = (VecEnv*)h;
  for (int i = 0; i < env->n; ++i)
    write_obs(env, i, obs_out + (size_t)i * env->obs_dim);
}

void mjvec_set_state(void* h, int i, const double* qpos,
                     const double* qvel) {
  auto* env = (VecEnv*)h;
  mjData* d = env->data[i];
  std::memcpy(d->qpos, qpos, sizeof(double) * env->nq);
  std::memcpy(d->qvel, qvel, sizeof(double) * env->nv);
  mj_forward(env->model, d);
}

void mjvec_step(void* h, const float* actions, float* true_next_obs,
                float* reward, uint8_t* terminal, uint8_t* done,
                float* obs_after) {
  auto* env = (VecEnv*)h;
  {
    std::lock_guard<std::mutex> lk(env->mu);
    env->cur_actions = actions;
    env->out_true_next = true_next_obs;
    env->out_reward = reward;
    env->out_terminal = terminal;
    env->out_done = done;
    env->out_obs_after = obs_after;
    env->pending = (int)env->workers.size();
    env->generation += 1;
  }
  env->cv_work.notify_all();
  {
    std::unique_lock<std::mutex> lk(env->mu);
    env->cv_done.wait(lk, [&] { return env->pending == 0; });
  }
}

void mjvec_destroy(void* h) {
  auto* env = (VecEnv*)h;
  {
    std::lock_guard<std::mutex> lk(env->mu);
    env->shutdown = true;
  }
  env->cv_work.notify_all();
  for (auto& t : env->workers) t.join();
  for (auto* d : env->data) mj_deleteData(d);
  mj_deleteModel(env->model);
  delete env;
}

}  // extern "C"
