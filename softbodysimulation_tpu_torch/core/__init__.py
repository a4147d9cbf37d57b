from . import config, scenes, state
