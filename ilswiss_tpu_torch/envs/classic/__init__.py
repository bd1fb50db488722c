from ilswiss_tpu_torch.envs.classic.cartpole import CartPole
from ilswiss_tpu_torch.envs.classic.mountain_car import MountainCarContinuous
from ilswiss_tpu_torch.envs.classic.pendulum import Pendulum
from ilswiss_tpu_torch.envs.classic.pendulum_pixels import PendulumPixels
