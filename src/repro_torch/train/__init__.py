"""Training utilities: the repo's own AdamW and schedules over tensor trees."""
