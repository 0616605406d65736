from .checkpoint import AsyncCheckpointer, latest_step, restore, save
