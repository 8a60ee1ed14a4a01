def get_data(args, return_val: bool = False, val_downscale: float = 4.0):
    """Dataset dispatch on args.data.type.

    This slice of the port carries the analytic `synthetic` scenes only; the
    file loaders are ROADMAP Queue A item 9 (loaders).
    """
    dataset_type = args.data.get("type", "DTU")
    if dataset_type != "synthetic":
        raise NotImplementedError(
            f"data type {dataset_type!r} is not ported yet (ROADMAP Queue A, "
            "item 9: loaders); only 'synthetic' is")
    from neurecon_tpu_torch.dataio.synthetic import SceneDataset

    cfgs = {
        "scale_radius": args.data.get("scale_radius", -1),
        "data_dir": args.data.get("data_dir", None),
        "downscale": args.data.downscale,
        "n_images": args.data.get("n_images", 16),
        "H": args.data.get("H", 120),
        "W": args.data.get("W", 160),
        "shape": args.data.get("shape", "sphere"),
        "background": args.data.get("background", "black"),
    }
    dataset = SceneDataset(**cfgs)
    if return_val:
        cfgs["downscale"] = val_downscale
        return dataset, SceneDataset(**cfgs)
    return dataset
