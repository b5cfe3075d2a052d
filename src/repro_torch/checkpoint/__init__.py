from repro_torch.checkpoint.serialize import load, load_raw, save, save_every

__all__ = ["load", "load_raw", "save", "save_every"]
