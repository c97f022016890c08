"""Weight sources and the validation step."""
