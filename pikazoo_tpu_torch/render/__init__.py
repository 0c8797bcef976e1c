from pikazoo_tpu_torch.render.renderer import Renderer

__all__ = ["Renderer"]
