from .settings import Settings, get_settings, load_settings

__all__ = ["Settings", "get_settings", "load_settings"]
