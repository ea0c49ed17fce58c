from .artifact import load_artifact, save_artifact

__all__ = ["load_artifact", "save_artifact"]
