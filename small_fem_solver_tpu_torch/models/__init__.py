"""Structural models: packed tensor mesh, presets, refinement."""
from .model import JacketModel, build_model, refine_model
from .presets import (DEFAULT_STORM, default_3leg_jacket,
                      default_3leg_jacket_geometry)
