"""caption_images_per_s: images whose captions reached the host in the
window, over the window's seconds (host clock; all work over all time)."""


def read(rec, ctx):
    if rec.get("kind") != "caption":
        return None
    return rec["images"] / rec["window_s"]
