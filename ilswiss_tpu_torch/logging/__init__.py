from ilswiss_tpu_torch.logging.logger import Logger
