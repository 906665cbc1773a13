"""Mission viewers: PNG panels of the map's render channels and the voxel
map per step (`viewer.MissionViewer`), and a live browser viewer with a
fly-cam (`webviewer.WebViewer`). Both import lazily: `webviewer` starts an
HTTP server only when a `WebViewer` is made."""

from .viewer import MissionViewer, render_channel_panel, scene_overlay, voxel_top_view  # noqa: F401
