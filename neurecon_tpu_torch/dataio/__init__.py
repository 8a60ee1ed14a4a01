from neurecon_tpu_torch.utils.io import decode_once


def get_data(args, return_val: bool = False, val_downscale: float = 4.0):
    """Dataset dispatch on args.data.type: DTU (the default), BlendedMVS
    (`BlendedMVS` or `blended_mvs`), custom, or the analytic `synthetic`
    scenes, which need no files. With `return_val`, also the same scene at
    `val_downscale`, from the same decoded images."""
    dataset_type = args.data.get("type", "DTU")
    cfgs = {
        "scale_radius": args.data.get("scale_radius", -1),
        "data_dir": args.data.get("data_dir", None),
        "downscale": args.data.downscale,
    }
    if dataset_type == "DTU":
        from neurecon_tpu_torch.dataio.dtu import SceneDataset
        cfgs["cam_file"] = args.data.get("cam_file", None)
    elif dataset_type in ("BlendedMVS", "blended_mvs"):
        from neurecon_tpu_torch.dataio.blendedmvs import SceneDataset
    elif dataset_type == "custom":
        from neurecon_tpu_torch.dataio.custom import SceneDataset
    elif dataset_type == "synthetic":
        from neurecon_tpu_torch.dataio.synthetic import SceneDataset
        cfgs.update({"n_images": args.data.get("n_images", 16),
                     "H": args.data.get("H", 120),
                     "W": args.data.get("W", 160),
                     "shape": args.data.get("shape", "sphere"),
                     "background": args.data.get("background", "black")})
    else:
        raise NotImplementedError(dataset_type)

    if not return_val:
        return SceneDataset(**cfgs)
    with decode_once():  # both read the same files: decode each once
        dataset = SceneDataset(**cfgs)
        cfgs["downscale"] = val_downscale
        return dataset, SceneDataset(**cfgs)
