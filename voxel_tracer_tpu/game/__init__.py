"""Headless game layer: the arcade-demo logic of the reference
(src/game/) without GLFW — drives dynamic voxel edits, laser paths and
per-frame transforms against the jitted renderer."""
