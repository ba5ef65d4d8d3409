"""Vocoder models."""
