"""Fused CNN-block IP family: conv -> pool -> activation in ONE launch."""
