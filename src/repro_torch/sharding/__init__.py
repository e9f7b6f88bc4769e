"""Logical-axis to mesh-axis rules for the dry run's meshes."""
