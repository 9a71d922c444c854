from diff3dhpe_torch.metrics.metrics import mean_velocity_error, mpjpe, n_mpjpe, p_mpjpe

__all__ = ["mean_velocity_error", "mpjpe", "n_mpjpe", "p_mpjpe"]
