"""The ray engine (`render_rays`)."""
