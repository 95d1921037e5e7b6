"""Structural models: packed tensor mesh, presets, refinement, member
auto-generation."""
from . import autogen
from .model import (JacketModel, add_appurtenances, build_model,
                    refine_model)
from .presets import (DEFAULT_STORM, default_3leg_jacket,
                      default_3leg_jacket_geometry)
