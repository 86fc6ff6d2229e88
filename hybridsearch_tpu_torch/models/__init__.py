"""Text encoders."""
