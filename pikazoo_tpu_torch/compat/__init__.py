from pikazoo_tpu_torch.compat.parallel_env import env, raw_env

__all__ = ["env", "raw_env"]
