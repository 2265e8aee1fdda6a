"""The plain references the cells are held against."""
