"""AdamW and learning-rate schedules over the port's parameter trees."""
