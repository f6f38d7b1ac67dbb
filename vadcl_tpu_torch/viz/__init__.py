from vadcl_tpu_torch.viz.dumps import error_heatmap, save_clip_frames

__all__ = ["error_heatmap", "save_clip_frames"]
