from vadcl_tpu_torch.utils.provenance import git_info, resolved_config, write_run_stamp

__all__ = ["git_info", "resolved_config", "write_run_stamp"]
