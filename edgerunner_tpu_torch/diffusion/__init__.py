from .schedulers import DiffusionSchedule, ddim_step, ddim_timesteps

__all__ = ["DiffusionSchedule", "ddim_step", "ddim_timesteps"]
