"""Published result tables and figure generators."""
