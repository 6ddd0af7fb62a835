"""Sensor models of the keyframe front-end."""
