"""Model clients, device selection and stage timing."""
