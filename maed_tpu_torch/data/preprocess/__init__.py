"""Dataset preprocessors: raw dataset layouts -> the DBs the data pipeline reads."""
