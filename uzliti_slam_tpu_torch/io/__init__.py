"""Synthetic inputs: pose graphs (``synthetic``) and RGB-D frames
(``simulator``)."""
