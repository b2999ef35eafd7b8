"""Extension packs (reference ``python/pathway/xpacks/``)."""
