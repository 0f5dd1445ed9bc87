from dynamont_jax.models.registry import get_model_path, load_model_for_pore

__all__ = ["get_model_path", "load_model_for_pore"]
