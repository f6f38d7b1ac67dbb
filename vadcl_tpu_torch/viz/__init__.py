from vadcl_tpu_torch.viz.dumps import error_heatmap, export_cluster_embedding, save_clip_frames

__all__ = ["error_heatmap", "export_cluster_embedding", "save_clip_frames"]
