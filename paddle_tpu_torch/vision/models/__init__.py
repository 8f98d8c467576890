from .swin import SwinTransformer, swin_b, swin_l, swin_s, swin_t

__all__ = ["SwinTransformer", "swin_t", "swin_s", "swin_b", "swin_l"]
