from diff3dhpe_torch.viz.render import (
    read_video,
    render_2d_animation,
    render_3d_animation,
    render_chain_animation,
    render_2d_figs,
    render_3d_figs,
    render_hypotheses_animation,
    render_video_overlay,
)

__all__ = [
    "read_video",
    "render_2d_animation",
    "render_3d_animation",
    "render_chain_animation",
    "render_2d_figs",
    "render_3d_figs",
    "render_hypotheses_animation",
    "render_video_overlay",
]
