"""Dataset sources: Pascal VOC (+SBD aug), Cityscapes, CamVid, ISIC-2017
(a copy of cutmix_seg_tpu.data.sources).

Re-derivation of the reference's datapipe sources
(reference: datapipe/pascal_voc_dataset.py, cityscapes_dataset.py,
camvid_dataset.py, isic2017_dataset.py) with the same on-disk formats (the
converter CLIs produce identical zips) and **bit-compatible split logic** —
train/val/test index selection from (n_val, val_rng, trainval_perm) uses the
same RandomState call order, since the chosen label set defines the task.

Differences from the reference by design:
  * a source returns raw NumPy arrays (uint8 HWC image, int32 labels); the
    torch Dataset/DataLoader machinery is replaced by the host pipeline in
    cutmix_seg_tpu_torch.data.loader (threaded decode; augmentation runs on
    device);
  * zip files are opened per-thread (the reference reopens per worker
    process; seg_data.py:127-153) since our decode pool is threaded.

Images and labels decode, and predictions encode, through the port's copy
of the native C++ decoder (``native.decode``), which returns exactly
``np.array(PIL.Image.open(data))`` and falls back to PIL where it does not
build.
"""

from __future__ import annotations

import os
import pickle
import threading
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np

from cutmix_seg_tpu_torch.data import settings
from cutmix_seg_tpu_torch.native.decode import decode_array, encode_png


def _holdout_split(train_ndx, val_ndx, n_val, val_rng, trainval_perm):
    """The shared n_val/test split logic (reference: e.g.
    pascal_voc_dataset.py:85-101): with n_val > 0 the official val set becomes
    the test set and the last n_val of the (permuted) train set become val."""
    test_ndx = None
    if n_val > 0:
        test_ndx = val_ndx
        if trainval_perm is not None:
            assert len(trainval_perm) == len(train_ndx)
            trainval = train_ndx[trainval_perm]
        else:
            trainval = train_ndx[val_rng.permutation(len(train_ndx))]
        train_ndx = trainval[:-n_val]
        val_ndx = trainval[-n_val:]
    else:
        if trainval_perm is not None:
            assert len(trainval_perm) == len(train_ndx)
            train_ndx = train_ndx[trainval_perm]
    return train_ndx, val_ndx, test_ndx


class DataSource:
    """Protocol: sample_names, train_ndx/val_ndx/test_ndx, num_classes,
    get_image(i) -> uint8 (H, W, 3), get_labels(i) -> int32 (H, W),
    get_mean_std(), canvas_hw (fixed host->device canvas size)."""

    sample_names: Sequence[str]
    train_ndx: np.ndarray
    val_ndx: np.ndarray
    test_ndx: Optional[np.ndarray]
    num_classes: int
    canvas_hw: Tuple[int, int]

    def get_image(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def get_labels(self, i: int) -> np.ndarray:
        raise NotImplementedError

    def get_mean_std(self):
        return np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])

    def save_prediction_by_index(self, out_dir, pred_y, i):
        path = os.path.join(out_dir, f"{self.sample_names[i]}.png")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # 16-bit gray PNG, same stored content as the reference's
        # Image.fromarray(pred.astype(np.uint32)).save (PNG has no 32-bit
        # depth; PIL writes mode-I as 16-bit) -- reference: seg_data.py:112-115
        with open(path, "wb") as f:
            f.write(encode_png(np.asarray(pred_y).astype(np.uint32)))


def _to_rgb_array(arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr[:, :, :3]


def _read_file_array(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_array(f.read())


class ZipSource(DataSource):
    """Zip-backed source with per-thread handles (zipfile is not thread-safe)."""

    def __init__(self, zip_path: str):
        self.zip_path = zip_path
        self._local = threading.local()

    @property
    def zip_file(self) -> zipfile.ZipFile:
        zf = getattr(self._local, "zf", None)
        if zf is None:
            zf = zipfile.ZipFile(self.zip_path, "r")
            self._local.zf = zf
        return zf

    def read_bytes(self, name: str) -> bytes:
        with self.zip_file.open(name) as f:
            return f.read()

    def read_array(self, name: str) -> np.ndarray:
        return decode_array(self.read_bytes(name))


def _load_names(path):
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


class PascalVOCDataSource(DataSource):
    """Loose-file VOC2012 (+ SBD augmented labels), 21 classes
    (reference: pascal_voc_dataset.py:46-160)."""

    canvas_hw = (512, 512)  # VOC images are <= 500x500

    def __init__(self, n_val, val_rng, trainval_perm, augmented=False,
                 fg_class_subset=None, root: Optional[str] = None):
        """``fg_class_subset``: restrict to images containing the given
        foreground classes and remap labels to [bg, subset...] (reference:
        pascal_voc_dataset.py:107-138)."""
        root = root or settings.get_data_path("pascal_voc")
        if augmented:
            train_names = _load_names(
                os.path.join(root, "ImageSets", "SegmentationAug", "train_aug.txt"))
            val_names = _load_names(
                os.path.join(root, "ImageSets", "SegmentationAug", "val.txt"))
            label_dir = "SegmentationClassAug"
        else:
            train_names = _load_names(
                os.path.join(root, "ImageSets", "Segmentation", "train.txt"))
            val_names = _load_names(
                os.path.join(root, "ImageSets", "Segmentation", "val.txt"))
            label_dir = "SegmentationClass"

        self.sample_names = sorted(set(train_names + val_names))
        name_to_index = {n: i for i, n in enumerate(self.sample_names)}
        train_ndx = np.array([name_to_index[n] for n in train_names])
        val_ndx = np.array([name_to_index[n] for n in val_names])

        self.y_paths = [os.path.join(root, label_dir, f"{n}.png")
                        for n in self.sample_names]
        self.x_paths = [os.path.join(root, "JPEGImages", f"{n}.jpg")
                        for n in self.sample_names]

        self.train_ndx, self.val_ndx, self.test_ndx = _holdout_split(
            train_ndx, val_ndx, n_val, val_rng, trainval_perm)
        self.num_classes = 21
        self.class_map = None

        if fg_class_subset is not None:
            fg = np.asarray(fg_class_subset)
            # valid-index pickle cache keyed by the subset string, so repeat
            # constructions skip the O(dataset) label decodes
            # (reference: pascal_voc_dataset.py:107-124). Deliberate fixes vs
            # the reference: the key includes the dataset flavour (plain vs
            # SBD-augmented have different index->image maps, so sharing one
            # cache silently corrupts splits), and a failed write (read-only
            # dataset mount) degrades to no caching instead of crashing.
            subset_str = "-".join(str(int(x)) for x in fg)
            flavour = "_aug" if augmented else ""
            cache_path = os.path.join(
                root, f"valid_images_fg_subset_{subset_str}{flavour}.pkl")
            keep = self._load_valid_index_cache(cache_path)
            if keep is None:
                fg_set = set(fg.tolist())
                keep = np.array([i for i in range(len(self.sample_names))
                                 if set(np.unique(self._raw_labels(i))) & fg_set])
                try:
                    # atomic write: a concurrent reader or an interrupted run
                    # must never observe a truncated pickle
                    tmp_path = cache_path + f".tmp{os.getpid()}"
                    with open(tmp_path, "wb") as f:
                        pickle.dump(
                            {"n_names": len(self.sample_names), "keep": keep}, f)
                    os.replace(tmp_path, cache_path)
                except OSError:
                    pass  # read-only dataset root: recompute next time
            keep = set(np.asarray(keep).tolist())
            self.train_ndx = np.array([i for i in self.train_ndx if i in keep])
            self.val_ndx = np.array([i for i in self.val_ndx if i in keep])
            self.num_classes = len(fg) + 1
            class_map = np.zeros((256,), dtype=np.uint8)
            class_map[fg] = np.arange(len(fg)) + 1
            class_map[255] = 255
            self.class_map = class_map

    def _load_valid_index_cache(self, cache_path):
        """Read the valid-index cache; None on absence, corruption, or a
        stale dataset (name-list length changed since the cache was built).
        Accepts the reference's bare-array format (no length check possible)
        and this framework's {'n_names', 'keep'} format."""
        if not os.path.exists(cache_path):
            return None
        try:
            with open(cache_path, "rb") as f:
                data = pickle.load(f)
        except Exception:
            return None  # truncated/corrupt: recompute (and rewrite)
        if isinstance(data, dict):
            if data.get("n_names") != len(self.sample_names):
                return None  # dataset changed underneath the cache
            return data["keep"]
        return data

    def get_image(self, i):
        return _to_rgb_array(_read_file_array(self.x_paths[i]))

    def _raw_labels(self, i):
        return _read_file_array(self.y_paths[i])

    def get_labels(self, i):
        y = self._raw_labels(i)
        if self.class_map is not None:
            y = self.class_map[y]
        return y.astype(np.int32)


class CityscapesDataSource(ZipSource):
    """Converted Cityscapes zip ({split}/{name}_x.png / _y.png), 19 classes
    after void remap (reference: cityscapes_dataset.py:6-141)."""

    CLASS_NAMES_WITH_VOID = [
        "unlabeled", "ego_vehicle", "rectification_border", "out_of_roi",
        "static", "dynamic", "ground",
        "road", "sidewalk", "parking", "rail_track",
        "building", "wall", "fence", "guard_rail", "bridge", "tunnel",
        "pole", "pole_group", "traffic_light", "traffic_sign",
        "vegetation", "terrain", "sky",
        "person", "rider",
        "car", "truck", "bus", "caravan", "trailer", "train",
        "motorcycle", "bicycle",
        "license_plate",
    ]
    VOID_CLASS_NAMES = [
        "unlabeled", "ego_vehicle", "rectification_border", "out_of_roi",
        "static", "dynamic", "ground",
        "parking", "rail_track",
        "guard_rail", "bridge", "tunnel",
        "pole_group",
        "caravan", "trailer",
        "license_plate",
    ]

    canvas_hw = (512, 1024)  # x2-downsampled converter output

    def __init__(self, n_val, val_rng, trainval_perm, with_void=False,
                 zip_path: Optional[str] = None):
        super().__init__(zip_path or settings.get_data_path("cityscapes"))
        names = set()
        for filename in self.zip_file.namelist():
            stem, ext = os.path.splitext(filename)
            if stem.endswith("_x") and ext.lower() == ".png":
                names.add(stem[:-2])
        self.sample_names = sorted(names)
        self.x_names = [f"{n}_x.png" for n in self.sample_names]
        self.y_names = [f"{n}_y.png" for n in self.sample_names]

        train_ndx = np.array([i for i, n in enumerate(self.sample_names)
                              if n.startswith("train/")])
        val_ndx = np.array([i for i, n in enumerate(self.sample_names)
                            if n.startswith("val/")])
        self.train_ndx, self.val_ndx, self.test_ndx = _holdout_split(
            train_ndx, val_ndx, n_val, val_rng, trainval_perm)

        self.with_void = with_void
        self.class_names = [n for n in self.CLASS_NAMES_WITH_VOID
                            if n not in self.VOID_CLASS_NAMES]
        mapping, out_i = [], 0
        for name in self.CLASS_NAMES_WITH_VOID:
            if name in self.VOID_CLASS_NAMES:
                mapping.append(255)
            else:
                mapping.append(out_i)
                out_i += 1
        self.non_void_mapping = np.array(mapping)
        self.num_classes = len(self.class_names)

    def get_image(self, i):
        return _to_rgb_array(self.read_array(self.x_names[i]))

    def get_labels(self, i):
        y = self.read_array(self.y_names[i])
        if not self.with_void:
            y = self.non_void_mapping[y]
        return y.astype(np.int32)


class CamVidDataSource(ZipSource):
    """CamVid zip, 11 classes (12th void -> 255), median-frequency weights
    (reference: camvid_dataset.py:21-79)."""

    canvas_hw = (384, 512)  # CamVid frames are 360x480

    def __init__(self, n_val, val_rng, trainval_perm, zip_path: Optional[str] = None):
        super().__init__(zip_path or settings.get_data_path("camvid"))
        names = set()
        dir_of = {}
        for filename in self.zip_file.namelist():
            dir_name, sample = os.path.split(filename)
            if not dir_name.endswith("annot") and \
                    os.path.splitext(sample)[1].lower() == ".png":
                names.add(sample)
                dir_of[sample] = dir_name
        self.sample_names = sorted(names)
        self.x_names = [dir_of[n] + "/" + n for n in self.sample_names]
        self.y_names = [dir_of[n] + "annot/" + n for n in self.sample_names]

        def by_suffix(suffix):
            return np.array([i for i, x in enumerate(self.x_names)
                             if os.path.split(x)[0].endswith(suffix)])

        self.train_ndx = by_suffix("train")
        self.val_ndx = by_suffix("val")
        self.test_ndx = by_suffix("test")
        if n_val > 0 and n_val < len(self.val_ndx):
            self.val_ndx = self.val_ndx[val_rng.permutation(len(self.val_ndx))[:n_val]]

        self.class_weights = np.array(
            [0.58872014284134, 0.51052379608154, 2.6966278553009,
             0.45021694898605, 1.1785038709641, 0.77028578519821,
             2.4782588481903, 2.5273461341858, 1.0122526884079,
             3.2375309467316, 4.1312313079834, 0])
        self.class_names = ["Sky", "Building", "Pole", "Road", "Pavement",
                            "Tree", "SignSymbol", "Fence", "Car", "Pedestrian",
                            "Bicyclist", "void"]
        self.num_classes = len(self.class_names) - 1

    def get_image(self, i):
        return _to_rgb_array(self.read_array(self.x_names[i]))

    def get_labels(self, i):
        y = self.read_array(self.y_names[i]).astype(np.int32)
        y[y == 11] = 255
        return y

    def get_mean_std(self):
        return (np.array([0.41189489566336, 0.4251328133025, 0.4326707089857]),
                np.array([0.27413549931506, 0.28506257482912, 0.28284674400252]))


class ISIC2017DataSource(ZipSource):
    """ISIC-2017 lesion zip (248x248 converter output), binary labels
    (img >= 127), dataset RGB stats from rgb_mean_std.pkl
    (reference: isic2017_dataset.py:9-90)."""

    canvas_hw = (256, 256)

    def __init__(self, n_val, val_rng, trainval_perm, zip_path: Optional[str] = None):
        super().__init__(zip_path or settings.get_data_path("isic2017"))
        names = set()
        for filename in self.zip_file.namelist():
            stem, ext = os.path.splitext(filename)
            if stem.endswith("_x") and ext.lower() == ".png":
                names.add(stem[:-2])
        self.sample_names = sorted(names)
        self.x_names = [f"{n}_x.png" for n in self.sample_names]
        self.y_names = [f"{n}_y.png" for n in self.sample_names]

        train_ndx = np.array([i for i, n in enumerate(self.sample_names)
                              if n.startswith("train/")])
        val_ndx = np.array([i for i, n in enumerate(self.sample_names)
                            if n.startswith("val/")])
        self.train_ndx, self.val_ndx, self.test_ndx = _holdout_split(
            train_ndx, val_ndx, n_val, val_rng, trainval_perm)

        self.class_names = ["background", "lesion"]
        self.num_classes = 2
        mean_std = pickle.loads(self.read_bytes("rgb_mean_std.pkl"))
        self.rgb_mean = mean_std["rgb_mean"]
        self.rgb_std = mean_std["rgb_std"]

    def get_image(self, i):
        return _to_rgb_array(self.read_array(self.x_names[i]))

    def get_labels(self, i):
        return (self.read_array(self.y_names[i]) >= 127).astype(np.int32)

    def get_mean_std(self):
        return self.rgb_mean, self.rgb_std
